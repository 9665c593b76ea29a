"""The port's deferred-check and plan-cache speculation protocol
(``TaskContext``) and its retry loop (``run_with_capacity_retry``),
against the reference's rules: one fetch at the task boundary, a
speculation miss before any hard check, learned values committed only by a
clean run (bools AND-ed, ints max-ed, merge-site decimal scales replaced),
capacity growth snapped to the ladder, stale keys dropped."""

import pytest
import torch

from ballista_tpu_torch.config import BallistaConfig
from ballista_tpu_torch.errors import CapacityError, ExecutionError, SpeculationMiss
from ballista_tpu_torch.exec.base import TaskContext, run_with_capacity_retry


def flag(v: bool) -> torch.Tensor:
    return torch.tensor(v)


def test_clean_run_commits_learned_values():
    cache = {"k_bool": True, "k_int": 5, ("dec_sum_last", "", "s", 0): 99}
    ctx = TaskContext(device="cpu", plan_cache=cache)
    done = []
    ctx.defer_check(flag(False), "never", required=torch.tensor(3))
    ctx.defer_speculation(flag(False), "never", ["k_int"])
    ctx.defer_learn("k_bool", flag(False))  # one batch says no: vetoes
    ctx.defer_learn("k_int", torch.tensor(4))  # ints take the max
    ctx.defer_learn("k_int", 7)
    ctx.defer_learn(("dec_sum_last", "", "s", 0), torch.tensor(2, dtype=torch.int32))
    ctx.defer_commit(lambda: done.append(1))
    ctx.raise_deferred()
    assert cache == {"k_bool": False, "k_int": 7, ("dec_sum_last", "", "s", 0): 2}
    assert done == [1]
    assert not (ctx.deferred_checks or ctx.speculative_checks or ctx.learned_values)


def test_speculation_miss_wins_and_commits_nothing():
    cache = {}
    ctx = TaskContext(device="cpu", plan_cache=cache)
    done = []
    ctx.defer_check(flag(True), "overflowed", required=torch.tensor(10))
    ctx.defer_speculation(flag(True), "stale", ["a", "b"])
    ctx.defer_learn("x", 1)
    ctx.defer_commit(lambda: done.append(1))
    with pytest.raises(SpeculationMiss) as e:
        ctx.raise_deferred()
    assert e.value.invalid_keys == ["a", "b"]
    assert cache == {} and done == []


def test_fired_checks_raise_capacity_or_execution_errors():
    ctx = TaskContext(device="cpu")
    ctx.defer_check(flag(True), "groups", required=torch.tensor(70_000))
    ctx.defer_check(flag(True), "more groups", required=torch.tensor(90_000))
    with pytest.raises(CapacityError) as e:
        ctx.raise_deferred()
    assert e.value.required == 90_000
    ctx.defer_check(flag(True), "collision run")  # no capacity would do
    with pytest.raises(ExecutionError) as e:
        ctx.raise_deferred()
    assert not isinstance(e.value, CapacityError)


def test_capacity_retry_grows_to_the_ladder_and_remembers():
    seen, hint, stats = [], {}, {}

    def run(ctx):
        seen.append(ctx.agg_capacity_override)
        cap = ctx.agg_capacity_override or ctx.config.agg_capacity()
        ctx.defer_check(torch.tensor(cap < 300_000), "groups", required=torch.tensor(300_000))
        return cap

    cfg = BallistaConfig()
    assert run_with_capacity_retry(cfg, run, device="cpu", hint=hint, stats=stats) == 1 << 19
    assert seen == [None, 1 << 19]  # 300,001 rounds up the 2048 * 2^k ladder
    assert hint == {"agg_capacity": 1 << 19} and stats == {"capacity_retries": 1}
    seen.clear()
    run_with_capacity_retry(cfg, run, device="cpu", hint=hint)
    assert seen == [1 << 19]  # a warm run starts at the grown capacity


def test_speculation_miss_drops_stale_keys_and_reruns():
    cache = {"flags": (False, False), "other": 1}
    stats = {}

    def run(ctx):
        stale = "flags" in ctx.plan_cache
        ctx.defer_speculation(torch.tensor(stale), "stale", ["flags"])
        return stale

    assert run_with_capacity_retry(
        BallistaConfig(), run, device="cpu", plan_cache=cache, stats=stats
    ) is False
    assert cache == {"other": 1} and stats == {"speculation_misses": 1}


def test_repeated_speculation_misses_give_up():
    def run(ctx):
        ctx.defer_speculation(flag(True), "always stale", ["k"])

    with pytest.raises(SpeculationMiss):
        run_with_capacity_retry(BallistaConfig(), run, device="cpu", plan_cache={})


def test_failed_attempt_leaves_the_plan_cache_as_it_found_it():
    # an entry written mid-run by an attempt that overflows was taken from
    # truncated intermediates: the retry must not see it
    cache = {"kept": 1}
    seen = []

    def run(ctx):
        seen.append(dict(ctx.plan_cache))
        ctx.plan_cache["written_mid_run"] = ctx.agg_capacity_override
        ctx.defer_check(
            torch.tensor(ctx.agg_capacity_override is None), "groups",
            required=torch.tensor(100_000),
        )

    run_with_capacity_retry(BallistaConfig(), run, device="cpu", plan_cache=cache)
    assert seen == [{"kept": 1}, {"kept": 1}]
    assert cache == {"kept": 1, "written_mid_run": 1 << 17}


def test_site_overflow_grows_that_site_alone():
    # a join's expansion outgrows its capacity: the retry grows that site
    # to the rows it needed, leaves the aggregates' capacity where it was,
    # and a warm run starts at the grown site capacity
    seen, hint, stats = [], {}, {}
    need = (1 << 25) + 3  # more than the aggregates' ceiling

    def run(ctx):
        seen.append((ctx.agg_capacity_override, dict(ctx.site_capacity)))
        cap = ctx.site_capacity.get("join", 4096)
        ctx.defer_check(
            torch.tensor(cap < need), "expansion", required=torch.tensor(need),
            site="join",
        )
        ctx.defer_check(torch.tensor(False), "groups", required=torch.tensor(0))
        return cap

    cfg = BallistaConfig()
    got = run_with_capacity_retry(cfg, run, device="cpu", hint=hint, stats=stats)
    assert got >= need
    assert seen == [(None, {}), (None, {"join": got})]
    assert hint == {"site_capacity": {"join": got}} and stats == {"capacity_retries": 1}
    seen.clear()
    run_with_capacity_retry(cfg, run, device="cpu", hint=hint)
    assert seen == [(None, {"join": got})]


def test_fired_site_and_aggregate_checks_each_carry_their_need():
    ctx = TaskContext(device="cpu")
    ctx.defer_check(flag(True), "groups", required=torch.tensor(70_000))
    ctx.defer_check(flag(True), "join a", required=torch.tensor(9_000), site="a")
    ctx.defer_check(flag(True), "join a again", required=torch.tensor(12_000), site="a")
    ctx.defer_check(flag(True), "join b", required=torch.tensor(5), site="b")
    with pytest.raises(CapacityError) as e:
        ctx.raise_deferred()
    assert e.value.required == 70_000
    assert e.value.sites == {"a": 12_000, "b": 5}
