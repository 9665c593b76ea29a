#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``ballista_tpu_torch``) on one
NVIDIA card.

    python3 chip_smoke.py [--sf 1] [--seed 42] [--warm 2] [--profile]
    python3 chip_smoke.py --prefix-only
    python3 chip_smoke.py --prefix-queries [--root CHECKOUT] [--warm 5]
    python3 chip_smoke.py --partition-timing [--root CHECKOUT]
    python3 chip_smoke.py --collect-timing [--root CHECKOUT] [--settings JSON]
    python3 chip_smoke.py --aqe-only [--sf 1]
    python3 chip_smoke.py --hooks-only [--sf 1]
    python3 chip_smoke.py --mesh-only [--sf 1]
    python3 chip_smoke.py --witness-only [--sf 1]
    python3 chip_smoke.py --surface-only

Phases, each of which fails the run (non-zero exit) when it fails:

1. Card: name, count, and ``nvidia-smi`` name and power limit. Without a
   CUDA device the script exits non-zero and prints no result.
2. Build: compile ``ballista_tpu_torch/csrc/onehot_agg.cu``,
   ``csrc/partition_hash.cu`` and ``csrc/prefix_sum.cu`` for sm_90a, one
   nvcc each, started together (``ops/cuda_build.build_many``), and print
   the build seconds and the ``-Xptxas -v`` report. Then TPC-H at ``--sf``
   (seed 42) for phases 4-17, written as Arrow IPC files into a temporary
   directory from which a process of its own (``CpuReference``, spawned,
   never touching the card) runs phase 6's CPU runs beside phases 3-5.
3. Kernel against its plain version at q1's shapes (n = 2^21 and 2^20,
   R = 14, P = 12, and q1's R = 6 once columns without nulls share a count
   row; at the two q1 shapes of n = 2^21 also the device time of a call by
   ``torch.profiler``), at P = 2048, 4096 and 65,536 and at a ragged n, with out-of-range
   slot ids and a NaN row: counts exact, sums within rtol 1e-12, the NaN in
   its own slot, two launches bit-identical. Times (CUDA events, after a
   warm-up): the kernel, the plain version, and one library call
   (``index_add_``) as a yardstick; the bound from the bytes and f64 adds.
   Then a sweep over slots P (nine values, 1 to 65,536) and value rows R
   (1, 2, 6, 14, 64) at q1's batch size, timing the kernel against its plain version (each point checked,
   two launches bit-identical), which finds for each R the P*R at which
   the kernel first loses to the plain scatter. Then the kernel's two
   launch modes ("lanes" and "owners", see ``ops/onehot_agg.launch_plan``)
   against each other and against ``index_add_`` from 256 slots on, on
   uniform slot ids, on Zipf-distributed ones (s = 1, hot slots scattered)
   and on ids of which 90% fall in one slot. Then 8 threads, each on its
   own stream, launch the kernel 50 times each at once, alternating six
   shapes whose plans take 33,816 to 215,184 bytes of shared memory on both
   arms (``CONCURRENT_SHAPES``): every launch succeeds and equals the same
   shape's launch from one thread bit for bit. Then the port's sort on the
   card against the CPU, on keys with +-0.0, NaN, a sign-bit NaN and +-inf.
   Then the prefix-sum kernel (``ops/prefix_sum``): the fault it repairs,
   ``torch.cumsum`` of one seed-made 6,000,000-row f64 column (uniform
   [0, 100), as phase 13's skewed table) 20 times on the card, with its
   distinct bit patterns counted, and the sort path's ``_column_cumsums``
   20 times (one pattern); then the kernel against its plain version on the
   CPU bit for bit (a NaN matching any NaN) at n = 6,000,000, 2^21, a
   ragged n, 1, around tile boundaries (4,095, 4,097, 17 * 4,096 - 1) and
   at 4,096^2 + 1 (four look-back levels), with k = 1, 2 and 6 columns
   holding -0.0, NaN and +-inf, 20 launches each bit-identical; at
   (6,000,000, 1 and 6) and (2^21, 1, 2 and 6) its device time
   (``torch.profiler``: the ``fixed_order_scan`` kernel and the memset of
   its flags), call time, host time, the plain version's time on the card,
   ``torch.cumsum`` along the rows (the library yardstick) and the bound
   (16 bytes a row a column).
   Then the partition-hash kernel against its plain version and a numpy
   uint64 oracle, bit for bit, at n = 2^21, 2^20 and a ragged n, on one
   int64 key, (int32, int64) keys, an f64 key with -0.0, NaNs, +-inf and
   f32-subnormal values, and a string key through its blake2b table with
   null rows; K in {1, 2, 4, 7, 64} with invalid rows (which come out as
   K) and the hash-only mode; two launches bit-identical; times of the
   kernel and the plain version at K = 64 with the bound. Then its grouped
   mode (``partition_groups``: ids, the rows' stable order by id, each
   bucket's start) against its plain version bit for bit, at n in {1,
   2048, a ragged n, 2^20, 2^21, 2^22} and K in {1, 2, 4, 7, 64, 1024}, on
   uniform keys, keys of which 90% share one value, rows all invalid and a
   string key with null rows, two launches bit-identical; both modes on
   keys made to hash to the edges of ``h % K`` against numpy's uint64
   ``%``. Then both modes' times at one int32 key and K = 64, at n = 2048,
   2^21 and 2^22 (``partition_timing``): device time (``torch.profiler``,
   the ``partition_*`` kernels), call time (CUDA events), host time of a
   call (``perf_counter`` over 200 calls without a sync), the plain
   version's time, the bound, and for the grouped mode the library
   yardstick (the ids call, a stable ``torch.argsort`` and a
   ``torch.bincount``).
4. Main path: TPC-H ``lineitem`` at ``--sf`` (seed 42) through
   ``TorchContext(device="cuda").sql(q).collect()`` for q1, q6 and a dense
   GROUP BY over four string keys (480 slots, ``WIDE_SQL``), one cold and
   ``--warm`` warm runs each, checked against a numpy oracle written here
   (filter, ``np.unique``, ``np.add.at`` in f64): keys and counts exact,
   floats within rtol 1e-9. The kernel's launch counter is zeroed
   just before and read just after; q1 must launch it (at SF >= 1, at
   least 4 times in one run). Every launch's (n, R, P) is recorded; after
   the counts and the peak memory are read, one more run of each query
   keeps the inputs of its first launch at each shape, and the kernel is
   held against its plain version on them (see phase 5).
   With ``--profile``, one more warm run of each query (here and in phase
   5) is traced with ``torch.profiler`` (device time by kernel, device idle
   share).
5. Joins: all eight TPC-H tables at ``--sf`` (seed 42) in one
   ``TorchContext(device="cuda")``; q18, q3, q4, q5 and q10 from
   ``benchmarks/queries/`` unchanged (q18 with its threshold of 300), one
   cold and ``--warm`` warm runs each, every run checked against a numpy
   oracle written here (keys, counts and row order exact, floats within
   rtol 1e-9), two warm runs bit-identical (money sums included). q18's
   first run must retry after its aggregate outgrows the default group
   capacity; q4 and q5 must launch the one-hot kernel (counter zeroed
   before each query, read after). ``ops/hashing.hash_columns`` on the
   card (the partition-hash kernel's hash-only mode) must equal a numpy
   uint64 splitmix64 bit for bit, on int64, f64 and f32 columns with -0.0,
   NaNs and extreme values. The exact decimal
   sums (``tests/test_decimal_exact.py``'s money table) on the card must
   equal the CPU's: the first run within rtol 1e-9, the third bit for bit.
   Prints per query the cold and warm seconds, rows, kernel launches and
   their (n, R, P), capacity retries and the host-device synchronizations
   of each run (torch's sync debug mode), then the phase's peak device
   memory. Then, as in phase 4, the kernel against its plain version on
   the inputs the queries gave it, one launch per distinct (n, R, P) (q4
   and q5 launch it at R = 1 and 2): two launches bit-identical, counts exact,
   sums within rtol 1e-12 of the correctly rounded sum (``math.fsum``) and
   of the plain version's sum give or take that version's own worst-case
   rounding error, with times and bound as in phase 3.
6. The rest: the same tables in new contexts; the TPC-H queries not run
   above (q2, q7-q9, q11-q17, q19-q22), a window query over ``orders``
   (``WINDOW_SQL``: ranking and running frame aggregates partitioned by
   customer) and a percentile query over ``lineitem`` (``PERCENTILE_SQL``:
   median and approx_percentile_cont by return flag). Each runs once
   through ``TorchContext(device="cpu")``, the port's plain path, in the
   process started before phase 3 (its seconds printed, and how long phase
   6 waited for that process); a query whose spec constants select nothing there runs
   with constants chosen from the data (``tpch.spec_substitutions``, the
   choice of ``tests/test_tpch_oracle.py``) and must then select rows. Then
   one cold and ``--warm`` warm runs on the card, each held against the
   CPU's result: schema, keys, counts and row order exact, floats within
   rtol 1e-9; two warm runs bit-identical and no warm run retrying; the
   money sums of the sort-based aggregate (``MONEY_SUMS``, exact decimals
   in every run) of the card's third run equal to the CPU's bit for bit.
   q12 and q22 must
   launch the kernel. Prints per query what phase 5 prints and the CPU
   seconds, then the phase's peak device memory; then the kernel against
   its plain version on the inputs these queries gave it, as in phase 5.
   Phases 5 and 6 also count and replay the partition-hash launches of
   hash-packed join keys.
7. Grace-hash spill and the distributed plans, on the tables of phase 5:
   q3, q5 and q18 in a ``TorchContext(device="cuda")`` with
   ``ballista.tpu.hbm_budget_mb=16`` (``GRACE_BUDGET_MB``), q5 one
   cold and one warm run, q3 (its warm run cut for the script's length)
   and q18 (some 20 s a run) one run each, held against the same query's unbudgeted card run
   (schema, keys, counts and row order exact, floats within rtol 1e-9, the
   sort path's money sums of q3 and q18 bit for bit); each run must take
   at least 2 grace passes with spilled bytes (``plan_counters``), every
   query must route rows through the partition-hash kernel, every spilled
   batch must be grouped by its grouped mode with one wait on the card
   (``exec/spill.stats``), q5's partial
   aggregates must launch the one-hot kernel at R = 2, and the spill root
   must hold no attempt directory afterwards. Then q1, q12 and q3 from
   ``PhysicalPlanner(ctx, 4, config=ctx.config, distributed=True)``,
   executed in process on the card (cold and warm), each equal to collect
   mode, q12 and q3 with a partitioned join. Prints per query the seconds,
   spill bytes and passes, partition-hash launches (all modes, and the
   grouped ones) and their (n, key columns, K, mode), one-hot launches,
   host syncs and the spill write's waits on the card, with its split
   (device ms of the grouping and of the copy, host s of queueing them, of
   the wait, of the Arrow build and of the IPC writes), the phase's peak
   device memory, and replays one partition-hash launch (and one one-hot
   launch) per distinct shape against its plain version: the budgeted
   queries' warm runs keep the inputs of their first launch at each shape
   (device copies, in the phase's peak memory), the distributed trees get
   one capture run each.
8. The staged path, on the tables of phase 5: q1, q3, q5 and q12 (q18
   runs on the distributed tier in phases 10 and 11 (e)) planned for the distributed tier (K = 4, ``STAGED_K``), split into
   stages (``distributed_plan.DistributedPlanner``), every stage's plan
   sent through proto bytes (``serde.BallistaCodec``; the decoded
   ``display()`` must equal the encoded one's), its inputs resolved to the
   files of the stages before it (``remove_unresolved_shuffles``), and one
   task an input partition run on the card under the retry loop, each
   writing Arrow IPC files into a temporary work directory
   (``executor/shuffle.ShuffleWriterExec``) that the next stage reads
   (``executor/reader.ShuffleReaderExec``), ``run_staged``; the directory
   is removed after each run. One cold and two warm runs each, held
   against collect mode on the card (schema, keys, counts and row order
   exact, floats within rtol 1e-9, the sort path's money sums of q3 bit
   for bit) and, for q1, q3 and q5, against the numpy oracles
   of phases 4 and 5; two warm runs bit-identical. Every hash-partitioned
   batch written must be grouped by the partition-hash kernel's grouped
   mode with one wait on the card, every query must record a grouped
   launch and q1 a one-hot launch. Prints per query the stages, tasks,
   shuffle files and MB, the kernels' launches and shapes, cold and warm
   seconds beside collect mode's, host syncs, the write split (device ms
   of the grouping and of the copy, host s of the Arrow build and of the
   IPC writes) and the read split (host s of the IPC reads and of the
   uploads), then the phase's peak device memory; then replays one launch
   per distinct shape of each kernel against its plain version.
9. The executor fleet, on the tables of phase 5: two port executors in
   this process (``executor/executor.Executor(device="cuda",
   provider=ctx)``), each with its own work directory, its own Arrow
   Flight service on 127.0.0.1 and a ``PollLoop`` of two task slots, poll
   a scheduler stand-in written here (``StandInScheduler``, served through
   ``scheduler/rpc.add_service``; it isolates the executors from the
   port's scheduler, which phase 10 runs). It plans and
   splits q1, q3, q5 and q12 at K = 4 as ``run_staged`` does and hands
   out each stage's TaskDefinitions, at most half a stage to one executor,
   once the stages before it completed, with their inputs resolved to the
   locations the statuses reported; the sessions turn off the local fast
   path (every shuffle read crosses Flight), eager and push shuffle. One
   cold and one warm run each (the second warm run cut for the script's
   length), held against collect mode and the numpy
   oracles as phase 8, the warm run bit for bit the cold one where
   neither retried; each run: both
   executors ran tasks, every task reported a cost vector and operator
   metrics, the Arrow bytes fetched over Flight equal those of the files
   later stages read (at least that when a task retried), every
   hash-partitioned batch was grouped by the kernel's grouped mode with one
   wait, q1 launched the one-hot kernel, and the executors' TTL sweep
   (``executor/cleanup``) leaves their work directories empty. Prints per
   query the tasks per executor, Flight MB and fetch seconds, cold and warm
   seconds beside phase 8's staged and collect mode's seconds, the tasks'
   cost vectors, then the phase's peak device memory; replays one launch
   per distinct shape of each kernel against its plain version. Meanwhile
   ``python -m ballista_tpu_torch.executor --device cuda`` runs as a
   subprocess (push-staged): it must register with the stand-in, heartbeat,
   and exit 0 within 10 s of a SIGTERM.
10. The port's own cluster, on the tables of phase 5: the scheduler
   (``scheduler/server.SchedulerServer``), the in-process cluster
   (``standalone.StandaloneCluster``) and the client
   (``client/context.BallistaContext``), every query sent as proto bytes
   of its logical plan and its result fetched back.
   (a) ``BallistaContext.standalone(device="cuda", n_executors=2,
   concurrent_tasks=2)``, pull-staged, at K = 4 and every other setting at
   its default (eager shuffle, push shuffle, the local fast path, the plan
   verifier and the skew monitor on): q1, q3, q5 and q12 one cold and two
   warm runs each, q18 (11-17 s a run) one cold run (its warm run cut to
   make room for phase 17), held
   against collect-mode results (phase 9's; q18's computed there without
   a fleet run) and the numpy oracles as phase 8 (money sums of q3 and
   q18 bit for bit); two warm runs bit-identical; each run recorded
   eager-fed or pushed reads
   (the readers' shipped ``eager_polls``, the executors' push registry),
   every hash-partitioned batch was grouped by the kernel's grouped mode
   with one wait, and q1 launched the one-hot kernel. (b) The same but
   q18 (cut to make room for phase 16) push-staged, one run each, held the
   same way. (c) The
   other seventeen TPC-H queries once each through cluster (a), held
   against the card's collect-mode results of phases 4-6 (the same SQL,
   spec constants that select nothing replaced from the data as in phase
   6; rows sorted). (d) A fresh two-executor cluster with tight liveness
   knobs (an executor expires after 5 s without a heartbeat, swept every
   second; an eager reader waits 5 s for its producer) loses, when q3's
   first stage finishes, the executor that ran its last task: q3 still equals collect mode and the
   scheduler reports the lost executor. (e) ``python -m
   ballista_tpu_torch.scheduler`` and ``python -m
   ballista_tpu_torch.executor --device cuda`` as subprocesses
   (push-staged), started on a thread of their own beside (a)-(d): the
   executor registers and heartbeats (the scheduler's
   executor roster, ``GetHistory``), ``BallistaContext.remote(...,
   device="cuda")`` opens a session, and both exit 0 within 10 s of a
   SIGTERM. Prints per query the stages and tasks per executor, Flight MB
   and fetch seconds, eager polls and pushed MB, cold and warm seconds
   beside phase 9's fleet seconds and collect mode's, retries, then the
   scheduler's queue-wait and job-latency histograms, the phase's peak
   device memory, and replays one launch per distinct shape of each kernel
   against its plain version.
11. File tables, on the tables of phase 5 written as Parquet files (row
   groups of 2^20 rows: lineitem 6, orders 2) into a temporary directory
   that is deleted after phase 12, every table registered by ``CREATE
   EXTERNAL TABLE``. (a) ``TorchContext(device="cuda")``: all 22 TPC-H
   queries (the SQL of phases 4-6) one cold and two warm runs each, held
   against the card's memory-table results of phases 4-6 (rows sorted:
   keys and counts exactly, floats within rtol 1e-9, the sort path's money
   sums of the third run bit for bit), two warm runs bit-identical and not
   retrying; q1 launches the one-hot kernel. (f) On the same context:
   ``SHOW TABLES``, ``SHOW COLUMNS FROM lineitem`` (against the file's
   schema), ``EXPLAIN VERBOSE`` (the physical plan the context plans),
   ``EXPLAIN VERIFY`` (no failure), ``EXPLAIN ANALYZE`` of q1 (its rows,
   the filter's rows against numpy, the scan's elapsed time) and ``DROP
   TABLE``. (b) A copy of lineitem sorted by l_shipdate: q6 and q1 with
   ``ballista.parquet.pruning`` on and off, equal to (a)'s; q6 prunes at
   least one row group when it is on and none when it is off. (c) Every
   row group its own streamed slice (``ParquetScanExec.STREAM_SLICE_BYTES``
   lowered, ``ballista.tpu.scan_stream_mb`` ``STREAM_MB``): q1, q6 and q18
   at ``ballista.tpu.prefetch_depth`` 0 and 1, each at least 3 slices,
   prefetches only at depth 1, equal to (a)'s and the two depths bit for
   bit. (d) nation, region and supplier as CSV (``WITH HEADER ROW``) and as
   Avro (the port's ``write_avro``), the rest Parquet: q5 and q7 cold and
   warm, equal to (a)'s. (e) ``BallistaContext.standalone(device="cuda",
   n_executors=2, concurrent_tasks=2)`` at K = 4, the eight tables created
   by DDL through the client (the executors open the files): q1, q3, q5
   and q12 (q18 runs on the cluster in phase 10) cold and once warm (the
   second warm run cut for the script's length),
   equal to (a)'s (money sums of q3 bit for bit) and the numpy oracles,
   the warm run bit for bit the cold one where no task retried,
   every run launching the grouped
   mode; ``GetFileMetadata`` of lineitem's
   file through the scheduler's stub returns its columns. Prints per query
   the cold and warm seconds and the scans' ``read_time``, pruned row
   groups, stream slices and prefetch hits and misses, the peak device
   memory of (a), (c) and (e), the phase's time with the ``nvidia-smi``
   line, and replays one launch per distinct shape of each kernel of the
   phase against its plain version.
12. The operator's surface, over phase 11's Parquet files. Phases 3-11
   and the processes they start run with ``BALLISTA_TPU_HINT_CACHE=off``,
   so their cold runs stay cold; each child of this phase gets its own
   hint directory, deleted at the end. (a) ``python -m
   ballista_tpu_torch.cli -f <script> --format csv --batch-size 8192`` as
   a child on the card: the script creates the eight tables by DDL and runs q1, q6 and
   q3, whose CSV output equals phase 11 (a)'s results (keys and counts
   exactly, floats within rtol 1e-9); prints the child's wall seconds.
   (b) Persisted hints: two fresh children sharing one new hint directory
   run q2 and q4 cold over the files; the first retries, the second makes
   no capacity retry or speculation miss and returns the first's tables
   bit for bit, and a third child with the cache ``off`` retries as the
   first did (the shell, the first and the third child run side by side,
   the second after the first); prints each query's cold seconds, retries and launches in
   each child and the size of ``plan_hints.json``. (c) The capacity
   ladder: q1, q6 and q18 over the memory tables, cold and warm, under
   ``ballista.tpu.capacity_buckets`` ``LADDER_SPEC`` and under the
   default, and q3 through the distributed planner in process under each
   (the partition-hash kernel): keys, counts and money sums bit for bit,
   other floats within rtol 1e-9, against phases 4-6 and across the
   ladders; the default ladder is restored. (d, e) ``python -m
   ballista_tpu_torch.scheduler --rest-port`` and two ``python -m
   ballista_tpu_torch.executor --device cuda --metrics-port`` processes;
   q1 and q3 through ``BallistaContext.remote`` over the files, equal to
   phase 11 (a)'s; KEDA's ``IsActive`` (on the scheduler's gRPC port) is
   true while a query runs and false after it; ``system.queries`` has the
   two jobs, ``system.task_attempts`` their tasks and ``system.executors``
   the two executors; ``/api/state``, ``/api/history``, ``/api/job/<id>``
   and ``/api/metrics`` answer, and every scrape (the scheduler's and each
   executor's) passes ``validate_exposition``; the three processes exit 0
   on SIGTERM. Replays one launch per distinct shape of (c)'s runs against
   the plain versions.
13. Adaptive query execution, on the tables of phase 5: the port's
   cluster (two executors on the card, K = 4) with ``ballista.tpu.aqe``
   on and eager shuffle off (eager consumers would close the window of a
   reactive rewrite), its strategy store persisted into a new hint
   directory that is deleted at the end. (a) The reference test's
   wrong-side build (``skewed_tables``, 6,000,000 fact rows, the fact on
   the build side of a string-keyed collect join) three times with AQE
   off and three times on: run 1 on applies a reactive flip of a build
   larger than its probe, runs 2 and 3 apply only learned strategies, a
   flip among them; keys and counts bit for bit AQE off's, ``SUM(v)``
   within rtol 1e-9 (it has no decimal scale, and the join's row order
   changes with the flip); AQE off's two warm runs bit for bit (the sort
   aggregate's f64 prefix is the fixed-order kernel's). (b) q1, q3, q5 and
   q12 twice each, held against phase 9's collect-mode results and
   the numpy oracles as phase 10 holds them (money sums of q3 and q18 bit
   for bit); every decision printed (op, source, outcome, stages,
   clause), with each run's grouped partition-hash K. (c) ``BALLISTA_AQE=0``
   over the same session: no decision, (a)'s query as AQE off runs it
   and q3 bit for bit collect mode's. The scheduler's
   ``ballista_aqe_rewrites_total`` and rewrite totals, from a scrape that
   passes ``validate_exposition``. (d) A new cluster over the same hint
   directory, the process's store dropped: its first run applies (a)'s
   learned flip. Prints warm seconds on and off, the rewrites accepted
   and rejected, the size of ``plan_hints.json``, the phase's peak device
   memory, and replays one launch per distinct shape of each kernel of
   the phase against its plain version.
14. UDF and UDAF plugins, on lineitem of phase 5: a port plugin file
   (``PLUGIN_SOURCE``: ``squareplus(x, y) = x*x + y``, ``clamp01``, the
   UDAF ``geo_mean`` with a SUM of ``log x`` and a COUNT state, and the
   UDAF ``spread`` with MAX, MIN and COUNT states) written into a new
   ``ballista.plugin_dir``, deleted at the end. (a)
   ``TorchContext(device="cuda")`` with that directory: the dense query
   (``PLUGIN_DENSE_SQL``, by l_returnflag and l_linestatus, a UDF in the
   filter and one under a SUM) and the sort-path query
   (``PLUGIN_SORT_SQL``, geo_mean by l_suppkey, top 20) one cold and two
   warm runs each, held against numpy oracles (``plugin_oracles``: keys
   and counts exactly, floats within rtol 1e-9), two warm runs bit for bit
   and no warm run retrying; the dense query must launch the one-hot
   kernel, the sort-path query the prefix-sum kernel. (b) The port's
   cluster (two executors on the card, K = 4) with the directory as a
   session setting: both queries the same way, also held against (a)'s
   results, and the sort-path query once more through ``functions.udaf``
   in the DataFrame builder; every task loads the plugin directory (the
   loader's calls counted against the jobs' tasks). Prints per query the
   seconds and each kernel's launches and shapes, and replays one launch
   per distinct shape of each kernel against its plain version (the
   prefix-sum kernel's at the inputs the queries gave it, bit for bit,
   with its call, plain, library and bound times, and device time at the
   largest).
15. The join build-table cache and the learned flip, on the tables of
   phase 5 and phase 13 (a)'s wrong-side build with an integer join key
   (``skewed_tables(..., int_keys=True)``, 6,000,000 fact rows,
   ``CACHE_FLIP_SQL``): one
   ``TorchContext(device="cuda")``; q18, q8, q17, q3, q5 and the flip
   query once cold, then two warm runs at ``ballista.tpu.build_cache_mb``
   0 and two at its default 2048, in turns (three each before the
   script's length cut them). Every run is held against
   phases 5 and 6's results (keys and counts exactly, floats within rtol
   1e-9, the sort path's money sums bit for bit) or a numpy oracle; all
   warm runs of a query bit for bit; no warm run retries; at 2048 warm
   runs keep no new table, at 0 no run offers one; the learned flip fires
   on every warm run of the flip query and on no cold one. Prints per
   query the warm seconds of both settings, the tables kept and skipped,
   the flips, retries and launches, the bytes the cache holds, and the
   peak device memory with the cache (its warm runs) and without it (one
   more warm round at 0, after the 2048 plan instances were dropped).
16. The adaptive capacity machinery (``adaptive_path``), on the tables of
   phase 5 in one ``TorchContext(device="cuda")`` at
   ``ballista.tpu.build_cache_mb`` 0: q18, q5, q3, q10, q6 and q13 once
   cold and twice warm (three times before the script's length cut it),
   each run held against phases 4-6's results,
   the warm runs bit for bit among themselves with no retry or miss;
   q18's lineitem aggregate on the disjoint-clustered path
   (``disjoint_break`` 0, ``final_disjoint_skip`` at least 1) and a shrink
   at some site of q18 and of q5. Then two forced stale cases, each one
   SpeculationMiss and one re-run to the right result: a filter whose
   input grew under its learned shrink capacity (``GROWN_SQL``), and q18
   over lineitem shuffled within each scan batch under its learned
   clustered-input entries. Prints the shrink sites learned, the
   presorted and state-slice entries, q18's counters, each warm run's
   retries and misses, a warm run's host syncs and the phase's peak
   device memory, and replays one launch per distinct shape of each
   kernel against its plain version.
17. The static-analysis gate and the durability witness. (a) ``python -m
   ballista_tpu_torch.analysis --json`` as a child process, on the full
   22-query corpus and the default device, beside (b) on the host's CPU:
   all twelve analyzers green and the suppression ledger within budget;
   prints each analyzer's seconds and the gate's wall seconds. (b)
   ``durability_path``: the port's
   scheduler on a ``SqliteBackend`` in a temp directory with
   ``BALLISTA_DUR_WITNESS=1``, one executor on the card; q1 and q3 held
   against the numpy oracles (they launch all three kernels); the
   witness's snapshot; the scheduler stopped and started again on the same
   sqlite file and port; once the executor re-registered,
   ``verify_restart`` and ``assert_no_divergence`` with checks above zero;
   q1 on the restarted cluster against its oracle; and
   ``ballista_dur_witness_checks_total`` scraped from the scheduler's
   ``/api/metrics``, printed by outcome. Any failure fails the script.
18. Prewarm and the trace hooks (``hooks_path``), on the tables of phase
   5. (a) Two child processes on the card, lineitem from an Arrow IPC
   file: one with ``ballista.tpu.prewarm`` off, one with it on at the
   default ladder up to ``tpu_batch_rows()``; the ``on`` child runs every
   signature it enumerated and none fails; q1 and q6 cold in both against
   the numpy oracles; the prewarm's seconds and count, each child's cold
   seconds and peak device memory printed. (b) One executor of the port's
   scheduler started with ``BALLISTA_TPU_PREWARM=background``: q1 while
   its prewarm runs, against collect mode (phase 9) and the oracle, and
   bit for bit q1 again after the prewarm; no ``compile-prewarm`` thread
   alive after the cluster stops. The launch counts of the main path
   start at that second q1: the prewarm's launches are printed apart,
   (a)'s from its child before any query, (b)'s with the first q1's. (c) q1 cold and warm on a collect
   context with ``ballista.tpu.profile_dir`` and on one without: every
   attempt writes a ``torch.profiler`` trace, the warm one holding the
   one-hot kernel's launch; the traced and untraced warm seconds printed.
   (d) EXPLAIN ANALYZE of q3 under phase 7's 16 MB budget with
   ``ballista.tpu.trace`` a JSONL path: one ``explain_analyze`` span and
   at least one ``spill_pass`` event with bytes.
19. The mesh tier (``mesh_path``), the shards on ``cuda:0``. (a)
   ``parallel/collective.exchange_by_key`` over 2^21 rows on 8 shards
   (an int64 key over 101 values with 10% nulls, an int64 row id): one
   partition-hash launch; every live row arrives once, on the shard a
   numpy splitmix64 of its key names; ids, rows, valid mask and overflow
   flags bit for bit the same call on CPU tensors; a bucket capacity of
   1024 sets every overflow flag; device ms (``torch.profiler``, 20
   calls), call ms and the bound (every byte read and written once).
   (b) q1, q3 (its ``ORDER BY ... LIMIT 10`` the mesh top-k), q5, q18, a
   full ORDER BY of orders (the sample sort) and phase 6's window query
   on ``TorchContext(device="cuda")`` with ``BALLISTA_TPU_MESH_SHARDS``
   at ``MESH_SHARDS`` (q5 at ``MESH_Q5_SHARDS``: a mesh join's output
   holds N times its larger input's capacity, PERF.md) beside a
   collect-mode context: the mesh operators in each plan's display; one
   cold run, then three warm runs with the mesh and three in collect
   mode, in turns; every run held against the numpy oracles (q1, q3, q5,
   q18) and the collect run (keys, counts and row order exactly, floats
   within rtol 1e-9; the window's running aggregates by the last value of
   each tie group), the warm mesh runs bit for bit; every mesh run but
   the sort's launches the partition-hash kernel, and the aggregates'
   the prefix-sum kernel. Prints per query the cold and warm seconds of
   both modes, the peak device memory, the launches by kernel and the
   capacity retries. (c) ``BallistaContext.standalone(device="cuda")``
   whose executor advertises ``MESH_SHARDS`` devices runs q3: the
   scheduler's stage plans and the operators the executor reports hold
   the mesh operators, and the result is (b)'s bit for bit. Then the
   launches of (b) and (c) are replayed against the plain versions.
20. The runtime witnesses on phase 5's tables. (a) Right after phase 5,
   on its ``TorchContext`` (so that phase 5's seconds stay as they were):
   its five queries once unwitnessed (phase 5's capture runs plan afresh
   and leave one plan cached) and once more with ``analysis/stalewitness``
   on at sample rate 1; each witnessed run is a physical-plan-cache hit
   that plans afresh and
   compares the two plans' renders: one ``physical_plan_cache`` match a
   query, no stale, each result bit for bit phase 5's warm one. (b) Last,
   after phase 19: the chaos scenario of
   ``tests/test_stalewitness_chaos.py`` on a two-executor cluster (the
   result cache at 64 MB, AQE on, phase 10 (d)'s liveness knobs), with
   the cache witness sampling every hit and the replay and resource
   witnesses on: q1 and q3 cold; q3 again (its hit demoted, resolving
   ``match``); q3 losing, at its first finished stage, the executor that
   ran that stage's last task (another demoted hit, resolving
   ``match``); ``customer`` registered again as the same object (its
   key flips: a miss); rows appended to
   ``customer`` that q3's segment filter drops (a miss, the same rows).
   Every result equals collect mode's (phase 9) and the numpy oracle,
   q3's revenue bit for bit; no stale hit, nothing pending
   (``pending_count`` drained with a deadline); the replay ledger clean
   with shuffle and result records; after the cluster closed, no live
   resource. (c) The replay property of
   ``tests/test_replay_witness.py``: q3 on a fresh two-executor cluster
   at fetch concurrency 1, with eager shuffle off and with zstd
   compression: one key set, every shuffle and result hash equal.
   Prints the cache counters by outcome, the replay records by kind, the
   resources acquired by kind and the live count after close, and the
   seconds of (a), (b) and (c); then its launches are replayed against
   the plain versions.
21. The user surface (``surface_path``): the port's four examples
   (``ballista_tpu_torch/examples``), in this process. (a) Each through
   its ``main`` on ``cuda`` and on ``cpu`` at the reference's row counts
   (100, 1,000, 10,000 and 1,000): the card's printed rows equal the
   CPU's (keys and counts exactly, floats within rtol 1e-9). (b) Each at
   the size a user would run: ``dataframe`` at 16,777,216 trips,
   ``udf_plugin`` at 6,000,000 points, ``standalone_sql`` and
   ``remote_sql`` at 1,000,000 CSV rows, each result held against a
   numpy oracle over the example's ``make_data`` (rtol 1e-9), with its
   seconds. (c) ``python -m ballista_tpu_torch.examples.standalone_sql``
   as a child with its default device, started first and run beside (a)
   and (b): it exits 0 and prints (a)'s rows. The launches of (a) and (b)
   by kernel (at least one) are replayed against the plain versions.
22. One JSON line of kernel results (the one-hot kernel, the
   partition-hash kernel's ids and grouped modes, and the prefix-sum
   kernel at the largest shape the main path gave it, with its launches
   on phases 4-21), then the card's name and power limit, then the last
   line ``{"ok": true, "device": {...}}``.

``--prefix-only`` runs phase 1, builds the prefix-sum kernel and runs
phase 3's prefix-sum checks, prints them, and stops. ``--prefix-queries``
runs phase 1, builds the kernels and times the two warm queries whose f64
SUMs take the prefix-sum kernel (phase 14's sort-path query on the
context, phase 13 (a)'s wrong-side build with AQE off on the cluster):
run it once per checkout (``--root``) in one call to compare two trees'
prefix kernels end to end on one card.
``--partition-timing`` runs phase 1, builds the partition-hash kernel and
prints ``partition_timing``'s results, and stops. With ``--root`` it
imports another checkout's ``ballista_tpu_torch`` (unpacked into a
gitignored directory such as ``build/``), so that two checkouts' kernels
are timed on one card in one call. ``--collect-timing`` runs phase 1,
builds both kernels, generates TPC-H at ``--sf`` and runs the 22 queries
over memory tables in one ``TorchContext(device="cuda")`` (session
settings from ``--settings``, a JSON object), one cold and ``--warm``
warm runs each, prints their seconds as one JSON line, and stops: run it
once per checkout (``--root``) in one call to compare two trees' warm
runs on one card. ``--aqe-only`` runs phase 1, builds both kernels,
generates TPC-H at ``--sf``, runs phase 13 with the five queries held
against one collect-mode run each on the card and the oracles, replays
its launches, prints its results as one JSON line, and stops.
``--adaptive-timing`` runs phase 1, builds the kernels, generates TPC-H at
``--sf`` and times phase 16's six queries (``adaptive_timing``: one cold
run, then ``--warm`` warm runs at ``build_cache_mb`` 0 and as many at
2048 in turns), prints them as one JSON line, and stops: run it once per
checkout (``--root``) in one call, in turns, to compare two trees.
``--analysis-only`` runs phase 1, builds the kernels, generates TPC-H at
``--sf``, runs phase 17 with the oracles of q1 and q3, prints its results
as one JSON line, and stops. ``--hooks-only`` runs phase 1, builds the
kernels, generates TPC-H at ``--sf``, runs phase 18 with the oracles of
q1 and q6 and one collect-mode q1 computed here, prints its results as
one JSON line, and stops. ``--mesh-only`` runs phase 1, builds the
kernels, generates TPC-H at ``--sf``, runs phase 19 with the oracles of
q1, q3, q5 and q18 computed here, replays its launches, prints its
results as one JSON line, and stops. ``--witness-only`` runs phase 1,
builds the kernels, generates TPC-H at ``--sf``, runs phase 5 (with the
oracles of q1 and q3 and their collect-mode results on its context) and
phase 20, replays their launches, prints the results as one JSON line,
and stops. ``--surface-only`` runs phase 1, builds the kernels, runs
phase 21, replays its launches, prints its results as one JSON line, and
stops.

Imports nothing of JAX or of the JAX package.
"""

from __future__ import annotations

import argparse
import json
import pathlib
import subprocess
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parent

# H100 SXM peaks (NVIDIA data sheet, dense, at the 700 W limit).
HBM_BYTES_PER_S = 3.35e12
FP64_FLOPS = 34e12  # f64 outside the tensor cores


class SmokeFailure(Exception):
    pass


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


def log(*a) -> None:
    print(*a, flush=True)


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    check(out.returncode == 0, f"nvidia-smi failed: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, iters: int = 20) -> float:
    import torch

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


# -- phase 3: the kernel against its plain version ---------------------------


def kernel_case(n: int, m: int, n_sums: int, P: int, seed: int, profiled: bool = False) -> dict:
    """One comparison at (n rows, m count rows + n_sums sum rows, P slots),
    with slot ids in [-1, P] (both ends dropped) and one NaN. ``profiled``
    adds the device time of a call (``torch.profiler``, the kernel's own
    programs)."""
    import torch

    from ballista_tpu_torch.ops import onehot_agg

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(seed)
    rid = torch.randint(-1, P + 1, (n,), generator=g, device=dev, dtype=torch.int32)
    R = m + n_sums
    vals = torch.empty(R, n, dtype=torch.float64, device=dev)
    vals[:m] = (torch.rand(m, n, generator=g, device=dev) < 0.9).to(torch.float64)
    vals[m:] = torch.rand(n_sums, n, generator=g, device=dev, dtype=torch.float64) * 1e4
    # one NaN in the first sum row, on a row that lands in slot `nan_slot`
    nan_row = int(torch.nonzero((rid >= 0) & (rid < P))[0, 0])
    nan_slot = int(rid[nan_row])
    vals[m, nan_row] = float("nan")

    got = onehot_agg.onehot_sums(rid, vals, P)
    again = onehot_agg.onehot_sums(rid, vals, P)
    want = onehot_agg.onehot_sums_plain(rid, vals, P)
    torch.cuda.synchronize()
    tag = f"n={n} R={R} P={P}"
    check(got.shape == (P, R), f"{tag}: shape {tuple(got.shape)}")
    check(
        torch.equal(got.view(torch.int64), again.view(torch.int64)),
        f"{tag}: two launches differ",
    )
    check(torch.equal(got[:, :m], want[:, :m]), f"{tag}: counts differ")
    nan_mask = torch.isnan(got)
    expect_nan = torch.zeros_like(nan_mask)
    expect_nan[nan_slot, m] = True
    check(torch.equal(nan_mask, expect_nan), f"{tag}: NaN not confined to its slot")
    ok = ~expect_nan
    err = (got[ok] - want[ok]).abs()
    rel = (err / want[ok].abs().clamp(min=1e-300)).max().item()
    check(
        torch.allclose(got[ok], want[ok], rtol=1e-12, atol=0.0),
        f"{tag}: sums differ, max rel err {rel:.3e}",
    )

    # timing (the NaN stays; it does not change the work)
    # the yardstick is one index_add_ call into a (P + 1, R) buffer whose
    # spare row takes the dropped rows (repeated calls accumulate; the work
    # is the same)
    idx = torch.where((rid >= 0) & (rid < P), rid, P).long()
    vt = vals.T
    buf = torch.zeros(P + 1, R, dtype=torch.float64, device=dev)

    def library():
        return buf.index_add_(0, idx, vt)

    ms = time_ms(lambda: onehot_agg.onehot_sums(rid, vals, P))
    plain_ms = time_ms(lambda: onehot_agg.onehot_sums_plain(rid, vals, P))
    library_ms = time_ms(library)
    bytes_moved = 4 * n + 8 * R * n + 8 * P * R
    ms_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
    ms_ops = n * R / FP64_FLOPS * 1e3
    res = dict(
        n=n, R=R, P=P, ms=ms, plain_ms=plain_ms, library_ms=library_ms,
        bound_ms=max(ms_bytes, ms_ops),
        bound_by="bytes" if ms_bytes >= ms_ops else "operations",
        max_abs_err=err.max().item(), max_rel_err=rel,
        plan=onehot_agg.launch_plan(n, R, P),
    )
    if profiled:
        res["device_ms"], res["device_kernels"] = profiled_device_ms(
            lambda: onehot_agg.onehot_sums(rid, vals, P), ONEHOT_KERNELS
        )
    log(f"kernel {tag}: ok  {json.dumps(res)}")
    return res


# the one-hot kernel's device programs (csrc/onehot_agg.cu): a lanes or an
# owners pass, then the reduction of its partials
ONEHOT_KERNELS = ("partial_sums", "owner_sums", "reduce_partials")


class LaunchRecorder:
    """While active, stands in for ``onehot_agg.onehot_sums`` (the dense
    route calls it through the module): each call on the card made while
    ``tag`` is set adds its (n, R, P) to ``shapes[tag]`` (unless
    ``counting`` is off); with ``keep`` set, the first call at each shape
    keeps a copy of its inputs for ``replay_launches`` (see
    ``capture_runs``), in host memory with ``keep_on_host`` (so that a
    counted run's peak device memory does not include it). The call itself
    goes to the wrapper as before and counts its launch there. It stands
    in for ``prefix_sum.prefix_sums`` (the sort aggregate's route) the same
    way, with its (n, k) in ``prefix_shapes``; it keeps a prefix sum's
    input only while ``keep_prefix`` is set too (``replay_prefix_launches``,
    phase 14)."""

    def __init__(self) -> None:
        self.tag: str | None = None
        self.keep = False
        self.keep_on_host = False
        self.keep_prefix = False
        self.counting = True
        self.shapes: dict = {}  # tag -> [(n, R, P), ...], one per launch
        self.inputs: dict = {}  # (n, R, P) -> (tag, rid, vals)
        self.prefix_shapes: dict = {}  # tag -> [(n, k), ...], one per launch
        self.prefix_inputs: dict = {}  # (n, k) -> (tag, x)

    def __enter__(self) -> "LaunchRecorder":
        from ballista_tpu_torch.ops import onehot_agg, prefix_sum

        self._mod, self._real = onehot_agg, onehot_agg.onehot_sums
        self._pmod, self._preal = prefix_sum, prefix_sum.prefix_sums

        def recorded_prefix(x):
            out = self._preal(x)
            if self.tag is not None and x.is_cuda:
                shape = (int(x.shape[1]), int(x.shape[0]))
                if self.counting:
                    self.prefix_shapes.setdefault(self.tag, []).append(shape)
                if self.keep and self.keep_prefix and shape not in self.prefix_inputs:
                    self.prefix_inputs[shape] = (self.tag, x.cpu() if self.keep_on_host else x.clone())
            return out

        prefix_sum.prefix_sums = recorded_prefix

        def recorded(rid, vals, P):
            out = self._real(rid, vals, P)
            if self.tag is not None and rid.is_cuda:
                shape = (int(rid.shape[0]), int(vals.shape[0]), int(P))
                if self.counting:
                    self.shapes.setdefault(self.tag, []).append(shape)
                if self.keep and shape not in self.inputs:
                    copy = (lambda x: x.cpu()) if self.keep_on_host else (lambda x: x.clone())
                    self.inputs[shape] = (self.tag, copy(rid), copy(vals))
            return out

        onehot_agg.onehot_sums = recorded
        return self

    def __exit__(self, *exc) -> None:
        self._mod.onehot_sums = self._real
        self._pmod.prefix_sums = self._preal


def capture_runs(recs: list, runs: dict) -> None:
    """One more run of each tag in ``runs`` (tag -> callable) under which a
    recorder of ``recs`` saw a launch, every recorder keeping the inputs of
    its first launch at each shape, each on a fresh plan (so that its joins
    build their tables again). It comes after the path's counts and
    peak memory were read, so that neither includes it or the copies; the
    prefix-sum kernel's launch count is set back to what it was before, as
    these runs are comparisons and not the main path."""
    from ballista_tpu_torch.exec.context import TorchContext
    from ballista_tpu_torch.ops import prefix_sum

    plaunches = prefix_sum.launches

    def prefix_kept(r):
        return r.prefix_shapes if getattr(r, "keep_prefix", False) else {}

    # a capture run plans afresh, so that its joins build their tables
    # again (a warm run takes them from the plan instance's build-table
    # cache, and the launches that built them would not come again)
    real_plan = TorchContext.create_physical_plan

    def fresh_plan(self, logical, sql=None):
        self._physical_cache.clear()
        self._plan_cache.pop("__build_cache_bytes__", None)
        return real_plan(self, logical, sql)

    TorchContext.create_physical_plan = fresh_plan
    for r in recs:
        r.keep, r.counting = True, False
    try:
        for q, run in runs.items():
            if any(r.shapes.get(q) or prefix_kept(r).get(q) for r in recs):
                for r in recs:
                    r.tag = q
                run()
                for r in recs:
                    missing = set(r.shapes.get(q, [])) - set(r.inputs)
                    missing |= set(prefix_kept(r).get(q, [])) - set(getattr(r, "prefix_inputs", {}))
                    check(not missing, f"{q}: the capture run missed launch shapes {sorted(missing)}")
    finally:
        TorchContext.create_physical_plan = real_plan
        prefix_sum.launches = plaunches
        for r in recs:
            r.keep, r.counting, r.tag = False, True, None


def exact_group_sums(rid, vals, P: int):
    """On the host: (the correctly rounded f64 sum of each slot's values in
    each row, by ``math.fsum``; the worst-case rounding error of a plain
    one-by-one f64 sum of the same values, gamma_k * sum|v| with k the
    slot's rows and gamma_k = k u / (1 - k u), u = 2^-53)."""
    import math

    import numpy as np

    r, v = rid.cpu().numpy(), vals.cpu().numpy()
    keep = (r >= 0) & (r < P)
    order = np.argsort(r[keep], kind="stable")
    rs, vs = r[keep][order], v[:, keep][:, order]
    ends = np.searchsorted(rs, np.arange(P + 1))
    R = v.shape[0]
    exact = np.zeros((P, R))
    abs_sum = np.zeros((P, R))
    for p in range(P):
        seg = vs[:, ends[p] : ends[p + 1]]
        for j in range(R):
            exact[p, j] = math.fsum(seg[j].tolist())
        abs_sum[p] = np.abs(seg).sum(axis=1)
    ku = np.diff(ends).astype(np.float64) * 2.0**-53
    return exact, (ku / (1 - ku))[:, None] * abs_sum


def replay_launches(rec: LaunchRecorder) -> list:
    """The kernel against its plain version on the very inputs the query
    paths gave it, one launch per distinct (n, R, P): two launches
    bit-identical; the 0/1 rows (the counts) exact and equal to the plain
    version's; every sum within rtol 1e-12 of the correctly rounded sum
    (``exact_group_sums``) and within rtol 1e-12 plus the plain version's
    own worst-case rounding error of the plain version's sum. (The plain
    version's one-by-one atomic adds miss the exact sum of q1's 2^20
    discounts in a slot by up to 3e-12 relative on an H100.) Times as in
    ``kernel_case``. These launches come after the paths' counts were
    read. The kept inputs are released."""
    import numpy as np
    import torch

    from ballista_tpu_torch.ops import onehot_agg

    out = []
    for (n, R, P), (tag, rid, vals) in sorted(rec.inputs.items()):
        rid, vals = rid.cuda(), vals.cuda()  # kept on the host by phase 9
        got = onehot_agg.onehot_sums(rid, vals, P)
        again = onehot_agg.onehot_sums(rid, vals, P)
        want = onehot_agg.onehot_sums_plain(rid, vals, P)
        torch.cuda.synchronize()
        what = f"{tag} launch n={n} R={R} P={P}"
        check(got.shape == (P, R), f"{what}: shape {tuple(got.shape)}")
        check(
            torch.equal(got.view(torch.int64), again.view(torch.int64)),
            f"{what}: two launches differ",
        )
        exact, plain_err = exact_group_sums(rid, vals, P)
        g, w = got.cpu().numpy(), want.cpu().numpy()
        counts = ((vals == 0) | (vals == 1)).all(dim=1).cpu().numpy()
        check(
            np.array_equal(g[:, counts], w[:, counts])
            and np.array_equal(g[:, counts], exact[:, counts]),
            f"{what}: counts differ",
        )
        rel_exact = np.abs(g - exact) / np.maximum(np.abs(exact), 1e-300)
        check(
            (np.abs(g - exact) <= 1e-12 * np.abs(exact)).all(),
            f"{what}: sums off the exact sum, max rel err {rel_exact.max():.3e}",
        )
        check(
            (np.abs(g - w) <= 1e-12 * np.abs(w) + plain_err).all(),
            f"{what}: sums differ from the plain version beyond its rounding",
        )
        idx = torch.where((rid >= 0) & (rid < P), rid, P).long()
        vt = vals.T
        buf = torch.zeros(P + 1, R, dtype=torch.float64, device=rid.device)
        ms_bytes = (4 * n + 8 * R * n + 8 * P * R) / HBM_BYTES_PER_S * 1e3
        ms_ops = n * R / FP64_FLOPS * 1e3
        res = dict(
            query=tag, n=n, R=R, P=P, count_rows=int(counts.sum()),
            ms=time_ms(lambda: onehot_agg.onehot_sums(rid, vals, P)),
            plain_ms=time_ms(lambda: onehot_agg.onehot_sums_plain(rid, vals, P)),
            library_ms=time_ms(lambda: buf.index_add_(0, idx, vt)),
            bound_ms=max(ms_bytes, ms_ops),
            bound_by="bytes" if ms_bytes >= ms_ops else "operations",
            max_abs_err=float(np.abs(g - w).max()),
            max_rel_err_vs_exact=float(rel_exact.max()),
            max_rel_err_plain_vs_exact=float(
                (np.abs(w - exact) / np.maximum(np.abs(exact), 1e-300)).max()
            ),
            plan=onehot_agg.launch_plan(n, R, P),
        )
        log(f"replay {what}: ok  {json.dumps(res)}")
        out.append(res)
    rec.inputs.clear()
    return out


# -- phase 3: the partition-hash kernel against its plain version -------------


class PartitionRecorder:
    """``LaunchRecorder`` for the partition-hash kernel's wrappers,
    ``partition.partition_hash`` (the join's hash packing reaches it through
    ``hashing.hash_columns``, the repartition through ``partition_ids``) and
    ``partition.partition_groups`` (the grace-hash spills): each call on
    the card made while ``tag`` is set adds its (n, key columns, K, mode)
    to ``shapes[tag]`` (mode ``ids``, K = 0 for the hash-only mode, or
    ``grouped``); with ``keep`` set, the first call at each shape keeps its
    inputs (in host memory with ``keep_on_host``)."""

    def __init__(self) -> None:
        self.tag: str | None = None
        self.keep = False
        self.keep_on_host = False
        self.counting = True
        self.shapes: dict = {}
        self.inputs: dict = {}  # (n, cols, K, mode) -> (tag, cols, nulls, tables, valid)

    def _wrap(self, real, mode: str):
        def recorded(cols, nulls, tables, valid, k):
            out = real(cols, nulls, tables, valid, k)
            if self.tag is not None and cols[0].is_cuda:
                shape = (int(cols[0].shape[0]), len(cols), int(k), mode)
                if self.counting:
                    self.shapes.setdefault(self.tag, []).append(shape)
                if self.keep and shape not in self.inputs:
                    one = (lambda x: x.cpu()) if self.keep_on_host else (lambda x: x.clone())
                    clone = lambda xs: [None if x is None else one(x) for x in xs]  # noqa: E731
                    self.inputs[shape] = (
                        self.tag, clone(cols), clone(nulls), clone(tables),
                        None if valid is None else one(valid),
                    )
            return out

        return recorded

    def __enter__(self) -> "PartitionRecorder":
        from ballista_tpu_torch.ops import partition

        self._mod = partition
        self._real = partition.partition_hash, partition.partition_groups
        partition.partition_hash = self._wrap(self._real[0], "ids")
        partition.partition_groups = self._wrap(self._real[1], "grouped")
        return self

    def __exit__(self, *exc) -> None:
        self._mod.partition_hash, self._mod.partition_groups = self._real


def partition_bound_ms(cols, nulls, tables, k: int, grouped: bool = False) -> tuple[float, str]:
    """The least time of one launch: its bytes at the card's memory rate
    (each key column, the valid mask in the partition-id mode, each null
    mask and string-table gather read once, the output written once; the
    grouped mode also reads its 4-byte ids back and writes 4 bytes of
    order a row); its integer work is far below the card's rate."""
    n = cols[0].shape[0]
    nbytes = sum(c.element_size() * n for c in cols)
    nbytes += n * sum(m is not None for m in nulls) + 8 * n * sum(t is not None for t in tables)
    nbytes += 5 * n if k else 8 * n
    nbytes += 8 * n if grouped else 0
    return nbytes / HBM_BYTES_PER_S * 1e3, "bytes"


def partition_kernel_phase(seed: int) -> dict:
    """The partition-hash kernel against its plain version and the numpy
    uint64 oracle, bit for bit, at n = 2^21, 2^20 and a ragged n, on one
    int64 key, (int32, int64) keys, an f64 key with -0.0, NaNs (one with the
    sign bit), +-inf and f32-subnormal values, and a string key through its
    blake2b table with null rows; K in {1, 2, 4, 7, 64} with some rows
    invalid (which must come out as K), and the hash-only mode; two launches
    bit-identical. Times at K = 64 (CUDA events after a warm-up) for the
    kernel and the plain version, with the bound; no single torch call
    computes this function, so no library time."""
    import numpy as np
    import torch

    from ballista_tpu_torch.ops import partition

    rng = np.random.default_rng(seed)
    words = tuple(f"word-{i:03d}" for i in range(37))
    table = partition._stable_string_hashes(words)
    cases, max_err = [], 0
    for n in (1 << 21, 1 << 20, 1_000_003):
        i64 = rng.integers(np.iinfo(np.int64).min, np.iinfo(np.int64).max, n, dtype=np.int64)
        i32 = rng.integers(np.iinfo(np.int32).min, np.iinfo(np.int32).max, n, dtype=np.int32)
        f64 = rng.normal(0, 1e3, n)
        f64[:12] = [-0.0, 0.0, np.nan, np.inf, -np.inf, 1e-40, -2e-39, 1.4e-45, 3e-38, 1e300, 0.1, -0.1]
        f64[12] = np.array([0xFFF8000000000000], dtype=np.uint64).view(np.float64)[0]
        f64[13:n:1000] = -0.0
        codes = rng.integers(-1, len(words) + 2, n).astype(np.int32)  # some out of range
        str_nulls = rng.random(n) < 0.2
        valid = rng.random(n) < 0.95
        keysets = {
            "i64": ([i64], [None], [None]),
            "i32+i64": ([i32, i64], [None, None], [None, None]),
            "f64": ([f64], [None], [None]),
            "str": ([codes], [str_nulls], [table]),
        }
        dev = lambda a: None if a is None else torch.from_numpy(  # noqa: E731
            a.view(np.int64) if a.dtype == np.uint64 else a
        ).cuda()
        valid_d = dev(valid)
        for name, (cols, nulls, tables) in keysets.items():
            dc, dn, dt = [dev(c) for c in cols], [dev(m) for m in nulls], [dev(t) for t in tables]
            tag = f"partition n={n} keys={name}"
            h = splitmix64_numpy(cols, nulls, tables)
            for k in (1, 2, 4, 7, 64, 0):
                got = partition.partition_hash(dc, dn, dt, valid_d, k)
                again = partition.partition_hash(dc, dn, dt, valid_d, k)
                plain = partition.partition_ids_plain(dc, dn, dt, valid_d, k)
                torch.cuda.synchronize()
                if k:
                    want = np.where(valid, (h % np.uint64(k)).astype(np.int32), np.int32(k))
                else:
                    want = h.view(np.int64)
                g = got.cpu().numpy()
                check(torch.equal(got, again), f"{tag} K={k}: two launches differ")
                check(torch.equal(got, plain), f"{tag} K={k}: kernel differs from the plain version")
                check(np.array_equal(g, want), f"{tag} K={k}: kernel differs from the numpy oracle")
                if k:
                    check((g[~valid] == k).all(), f"{tag} K={k}: an invalid row is not K")
                max_err = max(max_err, int((got.long() - plain.long()).abs().max()))
            bound, by = partition_bound_ms(dc, dn, dt, 64)
            res = dict(
                n=n, keys=name, K=64,
                ms=time_ms(lambda: partition.partition_hash(dc, dn, dt, valid_d, 64)),
                plain_ms=time_ms(lambda: partition.partition_ids_plain(dc, dn, dt, valid_d, 64)),
                bound_ms=bound, bound_by=by, library_ms=None,
            )
            log(f"{tag}: ok  {json.dumps(res)}")
            cases.append(res)
    zeros = torch.tensor([0.0, -0.0], dtype=torch.float64, device="cuda")
    check(
        len(set(partition.partition_hash([zeros], [None], [None], None, 0).tolist())) == 1,
        "partition: -0.0 and +0.0 hash apart",
    )
    return dict(cases=cases, max_abs_err=max_err)


def replay_partition_launches(prec: PartitionRecorder) -> list:
    """The partition-hash kernel against its plain version on the inputs
    the query paths gave it, one launch per distinct (n, key columns, K,
    mode): two launches and the plain version bit-identical (ids, and in
    the grouped mode the order and bucket starts too); times and bound as
    in ``partition_kernel_phase``. The kept inputs are released."""
    import torch

    from ballista_tpu_torch.ops import partition

    out = []
    for (n, ncols, k, mode), (tag, cols, nulls, tables, valid) in sorted(prec.inputs.items()):
        # kept on the host by phase 9
        cols, nulls, tables = ([None if x is None else x.cuda() for x in xs] for xs in (cols, nulls, tables))
        valid = None if valid is None else valid.cuda()
        args = (cols, nulls, tables, valid, k)
        if mode == "grouped":
            kernel, plain = partition.partition_groups, partition.partition_groups_plain
        else:
            kernel, plain = partition.partition_hash, partition.partition_ids_plain
        got, again, want = kernel(*args), kernel(*args), plain(*args)
        torch.cuda.synchronize()
        if mode != "grouped":
            got, again, want = (got,), (again,), (want,)
        what = f"{tag} partition launch n={n} cols={ncols} K={k} {mode}"
        check(all(map(torch.equal, got, again)), f"{what}: two launches differ")
        check(all(map(torch.equal, got, want)), f"{what}: kernel differs from the plain version")
        bound, by = partition_bound_ms(cols, nulls, tables, k, grouped=mode == "grouped")
        res = dict(
            query=tag, n=n, cols=ncols, K=k, mode=mode,
            dtypes=[str(c.dtype).removeprefix("torch.") for c in cols],
            ms=time_ms(lambda: kernel(*args)), plain_ms=time_ms(lambda: plain(*args)),
            bound_ms=bound, bound_by=by, library_ms=None, max_abs_err=0,
        )
        log(f"replay {what}: ok  {json.dumps(res)}")
        out.append(res)
    prec.inputs.clear()
    return out


def profiled_device_ms(fn, needle, iters: int = 20) -> tuple[float, dict]:
    """Device time of one ``fn()`` from a ``torch.profiler`` trace of
    ``iters`` calls (after a warm-up): the kernels whose names contain
    ``needle`` (a string, or a tuple of them), summed, over ``iters``; and
    each such kernel's mean ms."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    def dev_us(e):
        v = getattr(e, "self_device_time_total", None)
        return v if v is not None else getattr(e, "self_cuda_time_total", 0)

    for _ in range(3):
        fn()
    # a trace now and then comes back without the kernels (seen once in
    # some 30 traces of one process): trace again, up to three times. It
    # may also hold only some of the launches (a quarter of a prefix-sum
    # replay's, seen once); every kernel named launches once a call (true
    # of each caller), so a kernel's time a call is its mean over the
    # launches the trace holds
    for _ in range(3):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        events = [
            e for e in prof.key_averages()
            if getattr(e, "device_type", None) == DeviceType.CUDA
            and any(n in e.key for n in ((needle,) if isinstance(needle, str) else needle))
        ]
        if events:
            for e in events:
                if e.count != iters:
                    log(f"profiler: {e.key[:60]}: {e.count} launches traced in {iters} calls")
            rows = {e.key: dev_us(e) / 1e3 / e.count for e in events}
            return sum(rows.values()), {k[:60]: v for k, v in rows.items()}
    raise SmokeFailure(f"profiler: no kernel named *{needle}* in three traces")


def host_us(fn, calls: int = 200) -> float:
    """Host time of one ``fn()``: ``perf_counter`` over ``calls`` calls with
    no synchronization inside the loop (the launches queue up behind each
    other; the device time is not in it while the host is the slower)."""
    import torch

    for _ in range(5):
        fn()
    torch.cuda.synchronize()
    t = time.perf_counter()
    for _ in range(calls):
        fn()
    secs = time.perf_counter() - t
    torch.cuda.synchronize()
    return secs / calls * 1e6


def partition_timing(seed: int, ns=(2048, 1 << 21, 1 << 22), k: int = 64) -> list:
    """The partition-hash kernel's modes at the spills' shape (one int32
    key, 5% of the rows invalid, K = 64), at each n: the device time of a
    call (``torch.profiler``, kernels named ``partition_*``), its call time
    (CUDA events) and its host time (``host_us``). Modes: ``ids``
    (``partition_hash``) and, where the checkout has it, ``grouped``
    (``partition_groups``), each with its bound; the grouped mode also with
    its library yardstick (the ids call, a stable ``torch.argsort`` and a
    ``torch.bincount``). Works on any checkout's ``ops/partition.py`` that
    has ``partition_hash`` (``--partition-timing --root``)."""
    import numpy as np
    import torch

    from ballista_tpu_torch.ops import partition

    rng = np.random.default_rng(seed)
    out = []
    for n in ns:
        col = torch.from_numpy(rng.integers(-(2**31), 2**31 - 1, n).astype(np.int32)).cuda()
        valid = torch.from_numpy(rng.random(n) < 0.95).cuda()
        args = ([col], [None], [None], valid, k)
        modes = {"ids": lambda: partition.partition_hash(*args)}
        if hasattr(partition, "partition_groups"):
            modes["grouped"] = lambda: partition.partition_groups(*args)

        def library():
            pid = partition.partition_hash(*args)
            torch.argsort(pid, stable=True)
            return torch.bincount(pid, minlength=k + 1)

        for mode, fn in modes.items():
            device_ms, kernels = profiled_device_ms(fn, "partition_")
            # bytes: the key, the valid mask, 4 B of ids written; the grouped
            # mode also reads the ids back and writes 4 B of order a row
            nbytes = n * (4 + 1 + 4) + (8 * n if mode == "grouped" else 0)
            res = dict(
                mode=mode, n=n, keys="i32", K=k, device_ms=device_ms,
                ms=time_ms(fn), host_us=host_us(fn),
                bound_ms=nbytes / HBM_BYTES_PER_S * 1e3, bound_by="bytes",
                plain_ms=time_ms(
                    (lambda: partition.partition_groups_plain(*args)) if mode == "grouped"
                    else (lambda: partition.partition_ids_plain(*args))
                ),
                library_ms=time_ms(library) if mode == "grouped" else None,
                kernels=kernels,
            )
            res["bound_share"] = res["bound_ms"] / res["device_ms"]
            log(f"partition timing: {json.dumps(res)}")
            out.append(res)
    return out


GROUP_KS = (1, 2, 4, 7, 64, 1024)
_M64 = (1 << 64) - 1
_SPLITMIX = (0x9E3779B97F4A7C15, 0xBF58476D1CE4E5B9, 0x94D049BB133111EB)


def unsplitmix64(h: int) -> int:
    """The inverse of splitmix64 (each of its steps is a bijection of
    uint64): the lane that splitmix64 takes to ``h``."""
    c1, c2, c3 = _SPLITMIX

    def unxorshift(y, s):
        x = y
        for _ in range(64 // s):
            x = y ^ (x >> s)
        return x

    x = (unxorshift(h, 31) * pow(c3, -1, 1 << 64)) & _M64
    x = (unxorshift(x, 27) * pow(c2, -1, 1 << 64)) & _M64
    return (unxorshift(x, 30) - c1) & _M64


def edge_keys(k: int) -> tuple:
    """int64 keys whose one-column row hash is at an edge of ``h % k``
    (0, 1, 2^64 - 1, 2^63 and its neighbours, multiples of ``k`` at both
    ends of the range and their neighbours), with those hashes (uint64)."""
    import numpy as np

    top = _M64 // k
    hashes = {0, 1, _M64, _M64 - 1, 1 << 63, (1 << 63) - 1, (1 << 63) + 1}
    for m in (j * k for j in (1, 2, 3, top // 2, top - 1, top)):
        hashes.update(m + d for d in (-1, 0, 1) if 0 <= m + d <= _M64)
    hashes = sorted(hashes)
    keys = [unsplitmix64(unsplitmix64(h)) for h in hashes]
    return np.array(keys, dtype=np.uint64).view(np.int64), np.array(hashes, dtype=np.uint64)


def partition_groups_phase(seed: int) -> dict:
    """The grouped mode (``partition_groups``) against its plain version,
    bit for bit (ids, order, bucket starts), at n in {1, 2048, a ragged n,
    2^20, 2^21, 2^22} and K in {1, 2, 4, 7, 64, 1024}, on uniform int32
    keys, on keys of which 90% share one value (one bucket holds 90% of
    the valid rows), with every row invalid, and on a string key through its
    blake2b table with null rows (some codes out of range); two launches
    bit-identical; the bucket starts end at the valid rows and n. Then the
    ids and grouped modes on keys made to hash to the edges of ``h % K``
    (``edge_keys``), K up to 2^31 - 1, against numpy's uint64 ``%``."""
    import numpy as np
    import torch

    from ballista_tpu_torch.ops import partition

    rng = np.random.default_rng(seed)
    words = tuple(f"word-{i:03d}" for i in range(37))
    table = torch.from_numpy(partition._stable_string_hashes(words).view(np.int64)).cuda()
    dev = lambda a: torch.from_numpy(a).cuda()  # noqa: E731
    checked = 0
    for n in (1, 2048, 1_000_003, 1 << 20, 1 << 21, 1 << 22):
        i32 = rng.integers(-(2**31), 2**31 - 1, n).astype(np.int32)
        skew = np.where(rng.random(n) < 0.9, np.int32(7), i32)
        valid = dev(rng.random(n) < 0.95)
        codes = rng.integers(-1, len(words) + 2, n).astype(np.int32)
        cases = {
            "uniform": ([dev(i32)], [None], [None], valid),
            "skew90": ([dev(skew)], [None], [None], valid),
            "invalid": ([dev(i32)], [None], [None], torch.zeros_like(valid)),
            "str+nulls": ([dev(codes)], [dev(rng.random(n) < 0.2)], [table], valid),
        }
        for name, args in cases.items():
            for k in GROUP_KS:
                got = partition.partition_groups(*args, k)
                again = partition.partition_groups(*args, k)
                want = partition.partition_groups_plain(*args, k)
                torch.cuda.synchronize()
                tag = f"groups n={n} keys={name} K={k}"
                check(all(map(torch.equal, got, again)), f"{tag}: two launches differ")
                check(all(map(torch.equal, got, want)), f"{tag}: kernel differs from the plain version")
                check(
                    got[2][k].item() == args[3].sum().item() and got[2][k + 1].item() == n,
                    f"{tag}: the bucket starts do not end at the valid rows and n",
                )
                checked += 1
            log(f"groups n={n} keys={name}: ok at K in {GROUP_KS}")
    edges = 0
    for k in GROUP_KS + (3, 1000003, (1 << 31) - 1):
        keys, hashes = edge_keys(k)
        col, valid = [dev(keys)], torch.ones(len(keys), dtype=torch.bool, device="cuda")
        want = (hashes % np.uint64(k)).astype(np.int32)
        got = partition.partition_hash(col, [None], [None], valid, k).cpu().numpy()
        check(np.array_equal(got, want), f"edge hashes K={k}: the ids mode's modulo is wrong")
        if k <= partition.MAX_GROUPS:
            pid = partition.partition_groups(col, [None], [None], valid, k)[0].cpu().numpy()
            check(np.array_equal(pid, want), f"edge hashes K={k}: the grouped mode's modulo is wrong")
        edges += len(keys)
    res = dict(cases=checked, edge_hashes=edges, ok=True)
    log(f"groups: ok  {json.dumps(res)}")
    return res


def slot_ids(n: int, P: int, dist: str, g):
    """Slot ids in [0, P) on the card: "uniform"; "zipf" (the slot of rank
    k drawn with weight 1/k, ranks scattered over the slots by a random
    permutation); "hot90" (90% of the rows in slot P // 3, the rest
    uniform)."""
    import torch

    dev = torch.device("cuda")
    rid = torch.randint(0, P, (n,), generator=g, device=dev, dtype=torch.int32)
    if dist == "hot90":
        hot = torch.rand(n, generator=g, device=dev) < 0.9
        return torch.where(hot, torch.full_like(rid, P // 3), rid)
    if dist == "zipf":
        cdf = torch.cumsum(1.0 / torch.arange(1, P + 1, device=dev, dtype=torch.float64), 0)
        u = torch.rand(n, generator=g, device=dev, dtype=torch.float64) * cdf[-1]
        rank = torch.searchsorted(cdf, u).clamp(max=P - 1)
        perm = torch.randperm(P, generator=g, device=dev)
        return perm[rank].to(torch.int32)
    return rid


def check_sums(tag: str, got, again, want, m: int) -> None:
    """Two launches bit-identical, the m count rows exact, every sum within
    rtol 1e-12 of the plain version."""
    import torch

    check(
        torch.equal(got.view(torch.int64), again.view(torch.int64)),
        f"{tag}: two launches differ",
    )
    check(torch.equal(got[:, :m], want[:, :m]), f"{tag}: counts differ")
    check(torch.allclose(got, want, rtol=1e-12, atol=0.0), f"{tag}: sums differ")


# (R, P) of the concurrency check: plans of different shared memory on one
# instantiation of each arm (the lanes arm's 4-stage ring at 62,720, 92,968
# and 71,296 bytes: no lanes plan takes under 48 KB; the owners arm at
# 33,816, 50,224 and 215,184 bytes, on both sides of 48 KB)
CONCURRENT_SHAPES = ((6, 12), (64, 37), (14, 12), (1, 256), (2, 256), (6, 4096))


def onehot_concurrency(seed: int, threads: int = 8, calls: int = 50, n: int = 1 << 18) -> dict:
    """Task threads launching the one-hot kernel at once: ``threads``
    threads, each on its own stream, make ``calls`` launches, alternating
    the shapes of ``CONCURRENT_SHAPES``. Every launch must succeed, and each
    result equal the same shape's launch from one thread bit for bit (and
    so its plain version within the rounding bound that phase 3 checks). A
    launch that raised its kernel's shared-memory limit per call could see
    another thread lower it before its launch ("invalid argument")."""
    import threading

    import torch

    from ballista_tpu_torch.ops import onehot_agg

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(seed)
    cases = []
    for R, P in CONCURRENT_SHAPES:
        rid = torch.randint(-1, P + 1, (n,), generator=g, device=dev, dtype=torch.int32)
        vals = torch.rand(R, n, generator=g, device=dev, dtype=torch.float64) * 1e4
        vals[: R // 2] = (vals[: R // 2] < 9e3).to(torch.float64)  # count rows
        want = onehot_agg.onehot_sums(rid, vals, P)
        plain = onehot_agg.onehot_sums_plain(rid, vals, P)
        torch.cuda.synchronize()
        check_sums(f"concurrent R={R} P={P}", want, want, plain, R // 2)
        cases.append((rid, vals, P, want, onehot_agg.launch_plan(n, R, P)))
    errors: list = []
    differ: list = []
    launched = [0] * threads

    def worker(t: int) -> None:
        stream = torch.cuda.Stream()
        try:
            with torch.cuda.stream(stream):
                for j in range(calls):
                    rid, vals, P, want, _ = cases[(t + j) % len(cases)]
                    got = onehot_agg.onehot_sums(rid, vals, P)
                    launched[t] += 1
                    stream.synchronize()
                    if not torch.equal(got.view(torch.int64), want.view(torch.int64)):
                        differ.append((t, j, P))
        except Exception as e:  # noqa: BLE001 - every failure is reported below
            errors.append(f"thread {t}: {e!r}")

    t0 = time.perf_counter()
    pool = [threading.Thread(target=worker, args=(t,)) for t in range(threads)]
    for th in pool:
        th.start()
    for th in pool:
        th.join(timeout=300)
    secs = time.perf_counter() - t0
    check(not any(th.is_alive() for th in pool), "concurrent one-hot launches: a thread did not finish")
    check(not errors, f"concurrent one-hot launches failed: {errors[:3]}")
    check(not differ, f"concurrent one-hot launches differ from one thread's: {differ[:3]}")
    out = dict(
        threads=threads, launches=sum(launched), s=secs,
        smem={f"{c[4]['mode']} R={R} P={P}": c[4]["smem"] for (R, P), c in zip(CONCURRENT_SHAPES, cases)},
    )
    log(f"concurrent one-hot launches: ok  {json.dumps(out)}")
    return out


def modes(n: int, Rs: tuple, Ps: tuple, dists: tuple, seed: int) -> dict:
    """The kernel in each launch mode ("lanes", "owners") and one
    ``index_add_`` call, per slot-id distribution, R and P; each launch
    checked against the plain version."""
    import torch

    from ballista_tpu_torch.ops import onehot_agg

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(seed)
    auto = onehot_agg.launch_plan
    points = []
    try:
        for R in Rs:
            m = max(1, R // 2)
            vals = torch.empty(R, n, dtype=torch.float64, device=dev)
            vals[:m] = (torch.rand(m, n, generator=g, device=dev) < 0.9).to(torch.float64)
            vals[m:] = torch.rand(R - m, n, generator=g, device=dev, dtype=torch.float64)
            for dist in dists:
                for P in Ps:
                    rid = slot_ids(n, P, dist, g)
                    want = onehot_agg.onehot_sums_plain(rid, vals, P)
                    buf = torch.zeros(P + 1, R, dtype=torch.float64, device=dev)
                    idx, vt = rid.long(), vals.T
                    point = dict(R=R, P=P, dist=dist, auto=auto(n, R, P)["mode"])
                    for mode in ("lanes", "owners"):
                        onehot_agg.launch_plan = (
                            lambda n_, R_, P_, mode=mode: auto(n_, R_, P_, mode)
                        )
                        got = onehot_agg.onehot_sums(rid, vals, P)
                        again = onehot_agg.onehot_sums(rid, vals, P)
                        check_sums(f"{mode} n={n} R={R} P={P} {dist}", got, again, want, m)
                        point[mode + "_ms"] = time_ms(
                            lambda: onehot_agg.onehot_sums(rid, vals, P), iters=10
                        )
                        onehot_agg.launch_plan = auto
                    point["library_ms"] = time_ms(lambda: buf.index_add_(0, idx, vt), iters=10)
                    points.append(point)
    finally:
        onehot_agg.launch_plan = auto
    res = dict(n=n, points=points)
    log(f"modes: {json.dumps(res)}")
    return res


def crossover(n: int, Rs: tuple, Ps: tuple, seed: int) -> dict:
    """Kernel and plain-version times over a grid of (R, P) at ``n`` rows,
    each point checked (two launches bit-identical, counts exact, sums
    within rtol 1e-12). For each R, the smallest P*R at which the kernel is
    slower than the plain version (None if it never is on the grid)."""
    import torch

    from ballista_tpu_torch.ops import onehot_agg

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(seed)
    points, loses_at = [], {}
    for R in Rs:
        m = max(1, R // 2)
        vals = torch.empty(R, n, dtype=torch.float64, device=dev)
        vals[:m] = (torch.rand(m, n, generator=g, device=dev) < 0.9).to(torch.float64)
        vals[m:] = torch.rand(R - m, n, generator=g, device=dev, dtype=torch.float64)
        loses_at[R] = None
        for P in Ps:
            rid = torch.randint(0, P, (n,), generator=g, device=dev, dtype=torch.int32)
            got = onehot_agg.onehot_sums(rid, vals, P)
            again = onehot_agg.onehot_sums(rid, vals, P)
            want = onehot_agg.onehot_sums_plain(rid, vals, P)
            check_sums(f"crossover n={n} R={R} P={P}", got, again, want, m)
            ms = time_ms(lambda: onehot_agg.onehot_sums(rid, vals, P), iters=10)
            plain_ms = time_ms(lambda: onehot_agg.onehot_sums_plain(rid, vals, P), iters=10)
            plan = onehot_agg.launch_plan(n, R, P)
            points.append(dict(
                R=R, P=P, PR=P * R, ms=ms, plain_ms=plain_ms, mode=plan["mode"],
                chunks=plan["chunks"],
            ))
            if loses_at[R] is None and ms > plain_ms:
                loses_at[R] = P * R
    res = dict(n=n, points=points, kernel_loses_at_PR=loses_at)
    log(f"crossover: {json.dumps(res)}")
    return res


def sort_check(seed: int) -> dict:
    """``ops/perm.stable_argsort`` on the card against the CPU, in both
    directions, on f64 and f32 keys holding +-0.0, NaN, a NaN with its sign
    bit set, +-inf and ties: at n = 8 and at n = 2^21, so that both of
    torch's CUDA sort paths (the in-block sort and the radix sort) run."""
    import numpy as np
    import torch

    from ballista_tpu_torch.ops.perm import stable_argsort

    signed_nan = np.frombuffer(
        np.array([0xFFF8000000000001], dtype=np.uint64).tobytes(), dtype=np.float64
    )[0]
    specials = np.array(
        [0.0, -0.0, np.nan, signed_nan, np.inf, -np.inf, 1.0, -1.0, -0.0, 1.0]
    )
    rng = np.random.default_rng(seed)
    checked = 0
    for n in (8, 1 << 21):
        x = rng.choice(specials, n)
        x[: min(n, 8)] = specials[[3, 1, 0, 2, 4, 5, 8, 6]][:n]
        for dt in (torch.float64, torch.float32):
            t = torch.from_numpy(x).to(dt)
            for desc in (False, True):
                want = stable_argsort(t, desc)
                got = stable_argsort(t.cuda(), desc).cpu()
                check(
                    torch.equal(got, want),
                    f"sort n={n} {dt} descending={desc}: the card's permutation "
                    "differs from the CPU's",
                )
                checked += 1
    res = dict(cases=checked, ok=True)
    log(f"sort: ok  {json.dumps(res)}")
    return res


PREFIX_SHAPES = ((6_000_000, 1), (6_000_000, 2), (6_000_000, 6), (1 << 21, 1), (1 << 21, 2),
                 (1 << 21, 6), (1_000_003, 1), (1_000_003, 2), (1_000_003, 6), (1, 1), (1, 2), (1, 6),
                 (4095, 1), (4097, 2), (17 * 4096 - 1, 3), (4096 * 4096 + 1, 1))
# the kernel's device work a call: the scan and the memset of its flags
PREFIX_DEVICE_OPS = ("fixed_order_scan", "Memset")


def same_bits(a, b) -> bool:
    """Bit for bit (host tensors), where a NaN matches any NaN: the card's
    adds and the CPU's do not carry a NaN's payload alike."""
    import torch

    if a.shape != b.shape or not torch.equal(torch.isnan(a), torch.isnan(b)):
        return False
    ok = ~torch.isnan(a)
    return torch.equal(a[ok].view(torch.int64), b[ok].view(torch.int64))


def prefix_columns(n: int, k: int, seed: int):
    """k seed-made columns of n rows, uniform [0, 100) as the skewed
    table's values, every third row scaled by -1e-3, with -0.0 in every
    column, a NaN in the second and +-inf in the third (mod 3)."""
    import numpy as np
    import torch

    rng = np.random.default_rng(seed)
    x = rng.uniform(0, 100, (k, n))
    x[:, ::3] *= -1e-3
    for c in range(k):
        at = rng.integers(0, n, 4)
        x[c, at[0]] = -0.0
        if c % 3 == 1:
            x[c, at[1]] = np.nan
        if c % 3 == 2 and n > 2:
            x[c, at[2]], x[c, at[3]] = np.inf, -np.inf
    return torch.from_numpy(x)


def prefix_bound_ms(n: int, k: int) -> tuple[float, str]:
    """Each input read once and each output written once (16 bytes a row a
    column) at 3.35 TB/s; the adds (n k, plus the levels' n k / 16 + ...)
    at the f64 rate are far smaller."""
    return max(16 * n * k / HBM_BYTES_PER_S, 1.07 * n * k / FP64_FLOPS) * 1e3, "bytes"


def prefix_case(x, repeats: int = 20, timed: bool = False) -> dict:
    """The prefix-sum kernel on ``x`` (k, n) against its plain version on
    the CPU, bit for bit, and ``repeats`` launches bit-identical with each
    other; ``timed`` adds the device time (``torch.profiler``, the scan
    and its memset), the call time (CUDA events), the host time, the plain
    version's time on the card, ``torch.cumsum`` along the rows (the
    library yardstick) and the bound."""
    import torch

    from ballista_tpu_torch.ops import prefix_sum

    k, n = x.shape
    xd = x.cuda()
    first = prefix_sum.prefix_sums(xd)
    for i in range(repeats - 1):
        again = prefix_sum.prefix_sums(xd)
        check(torch.equal(again.view(torch.int64), first.view(torch.int64)),
              f"prefix n={n} k={k}: launch {i + 2} differs from launch 1")
    torch.cuda.synchronize()
    want = prefix_sum.prefix_sums_plain(x)
    got = first.cpu()
    check(same_bits(got, want), f"prefix n={n} k={k}: kernel differs from its plain version")
    res = dict(n=n, k=k, launches=repeats, max_abs_err=0.0, bit_for_bit=True)
    if timed:
        bound, by = prefix_bound_ms(n, k)
        device_ms, kernels = profiled_device_ms(lambda: prefix_sum.prefix_sums(xd), PREFIX_DEVICE_OPS)
        res.update(
            device_ms=device_ms, ms=time_ms(lambda: prefix_sum.prefix_sums(xd)),
            host_us=host_us(lambda: prefix_sum.prefix_sums(xd)),
            plain_ms=time_ms(lambda: prefix_sum.prefix_sums_plain(xd)),
            library_ms=time_ms(lambda: torch.cumsum(xd, dim=1)),
            bound_ms=bound, bound_by=by, kernels=kernels,
        )
        res["bound_share"] = bound / device_ms
    return res


def prefix_phase(seed: int) -> dict:
    """Phase 3's prefix-sum checks. First the fault it repairs: the old
    sort-path prefix (one ``torch.cumsum`` of a 1-D column on the card) 20
    times on one seed-made 6,000,000-row f64 column, uniform [0, 100) as
    the skewed table's values, counting the distinct bit patterns; then
    the new ``_column_cumsums`` 20 times on it (one pattern). Then the
    kernel against its plain version at every ``PREFIX_SHAPES`` (n, k),
    20 launches each bit-identical, timed at the main path's shapes."""
    import numpy as np
    import torch

    from ballista_tpu_torch.ops import aggregate, prefix_sum

    col = torch.from_numpy(np.random.default_rng(seed).uniform(0, 100, 6_000_000)).cuda()
    old = [torch.cumsum(col, 0).view(torch.int64) for _ in range(20)]
    new = [aggregate._column_cumsums([col])[:, 0].contiguous().view(torch.int64) for _ in range(20)]
    torch.cuda.synchronize()

    def patterns(runs):
        uniq = []
        for r in runs:
            if not any(torch.equal(r, u) for u in uniq):
                uniq.append(r)
        return len(uniq)

    old_rel = max(
        float(((r.view(torch.float64) - old[0].view(torch.float64)).abs()
               / old[0].view(torch.float64).abs().clamp(min=1e-300)).max())
        for r in old
    )
    cause = dict(rows=6_000_000, runs=20, cumsum_patterns=patterns(old),
                 cumsum_max_rel_diff=old_rel, fixed_order_patterns=patterns(new))
    log(f"prefix cause: {json.dumps(cause)}")
    check(cause["fixed_order_patterns"] == 1, "prefix: _column_cumsums differs from run to run")
    del old, new
    timed_at = {(6_000_000, 1), (6_000_000, 6), (1 << 21, 1), (1 << 21, 2), (1 << 21, 6)}
    before = prefix_sum.launches
    cases = []
    for i, (n, k) in enumerate(PREFIX_SHAPES):
        res = prefix_case(prefix_columns(n, k, seed + i), timed=(n, k) in timed_at)
        log(f"prefix case: ok  {json.dumps(res)}")
        cases.append(res)
    # comparisons, not the main path: the count is the main path's alone
    prefix_sum.launches = before
    return dict(cause=cause, cases=cases)


def replay_prefix_launches(rec: "LaunchRecorder") -> list:
    """The prefix-sum kernel on the inputs the queries gave it, one launch
    per distinct (n, k): against its plain version on the CPU bit for bit,
    two launches bit-identical, with call, plain, library and bound times.
    The launch count is set back afterwards (comparisons, not the main
    path)."""
    import torch

    from ballista_tpu_torch.ops import prefix_sum

    before = prefix_sum.launches
    out = []
    largest = max(rec.prefix_inputs, key=lambda s: (s[0] * s[1], s), default=None)
    for (n, k), (tag, x) in sorted(rec.prefix_inputs.items()):
        xd = x.cuda() if not x.is_cuda else x
        kernel = rec._preal
        got, again = kernel(xd), kernel(xd)
        torch.cuda.synchronize()
        check(torch.equal(got.view(torch.int64), again.view(torch.int64)),
              f"replay prefix {tag} n={n} k={k}: two launches differ")
        check(same_bits(got.cpu(), prefix_sum.prefix_sums_plain(xd.cpu())),
              f"replay prefix {tag} n={n} k={k}: kernel differs from its plain version")
        bound, by = prefix_bound_ms(n, k)
        res = dict(
            query=tag, n=n, k=k, ms=time_ms(lambda: kernel(xd)),
            plain_ms=time_ms(lambda: prefix_sum.prefix_sums_plain(xd)),
            library_ms=time_ms(lambda: torch.cumsum(xd, dim=1)),
            bound_ms=bound, bound_by=by, max_abs_err=0.0, bit_for_bit=True,
        )
        if (n, k) == largest:
            res["device_ms"], res["kernels"] = profiled_device_ms(lambda: kernel(xd), PREFIX_DEVICE_OPS)
        log(f"replay {tag} prefix launch n={n} k={k}: ok  {json.dumps(res)}")
        out.append(res)
    rec.prefix_inputs.clear()
    prefix_sum.launches = before
    return out


# -- phase 4: the main path against a numpy oracle ---------------------------


def oracle_q1(cols: dict):
    import numpy as np

    keep = cols["l_shipdate"] <= 10471  # date '1998-12-01' - interval '90' day
    rf = cols["l_returnflag"][keep]
    ls = cols["l_linestatus"][keep]
    qty = cols["l_quantity"][keep]
    price = cols["l_extendedprice"][keep]
    disc = cols["l_discount"][keep]
    tax = cols["l_tax"][keep]
    keys = np.char.add(rf.astype("U1"), ls.astype("U1"))
    uniq, inv = np.unique(keys, return_inverse=True)
    g = len(uniq)

    def gsum(v):
        out = np.zeros(g, dtype=np.float64)
        np.add.at(out, inv, v.astype(np.float64))
        return out

    cnt = np.zeros(g, dtype=np.int64)
    np.add.at(cnt, inv, 1)
    disc_price = price * (1 - disc)
    return {
        "l_returnflag": [k[0] for k in uniq],
        "l_linestatus": [k[1] for k in uniq],
        "sum_qty": gsum(qty),
        "sum_base_price": gsum(price),
        "sum_disc_price": gsum(disc_price),
        "sum_charge": gsum(disc_price * (1 + tax)),
        "avg_qty": gsum(qty) / cnt,
        "avg_price": gsum(price) / cnt,
        "avg_disc": gsum(disc) / cnt,
        "count_order": cnt,
    }


# A dense GROUP BY over four string keys of lineitem: 8 * 5 * 4 * 3 = 480
# slots (each vocabulary plus NULL), where q1 has 12.
WIDE_SQL = (
    "select l_shipmode, l_shipinstruct, l_returnflag, l_linestatus, "
    "count(*) as count_order, sum(l_quantity) as sum_qty, "
    "sum(l_extendedprice) as sum_base_price, avg(l_discount) as avg_disc "
    "from lineitem group by l_shipmode, l_shipinstruct, l_returnflag, "
    "l_linestatus order by l_shipmode, l_shipinstruct, l_returnflag, l_linestatus"
)


def oracle_wide(cols: dict):
    import numpy as np

    names = ("l_shipmode", "l_shipinstruct", "l_returnflag", "l_linestatus")
    # each key's sorted values and codes, mixed into one group number whose
    # order is that of the key tuples
    vocab, code = [], np.zeros(len(cols[names[0]]), dtype=np.int64)
    for c in names:
        v, inv = np.unique(cols[c], return_inverse=True)
        vocab.append(v)
        code = code * len(v) + inv
    groups, inv = np.unique(code, return_inverse=True)
    g = len(groups)

    def gsum(v):
        out = np.zeros(g, dtype=np.float64)
        np.add.at(out, inv, v.astype(np.float64))
        return out

    cnt = np.zeros(g, dtype=np.int64)
    np.add.at(cnt, inv, 1)
    out = {}
    rest = groups
    for c, v in reversed(list(zip(names, vocab))):
        out[c] = list(v[rest % len(v)])
        rest = rest // len(v)
    out = {c: out[c] for c in names}
    out.update(
        count_order=cnt,
        sum_qty=gsum(cols["l_quantity"]),
        sum_base_price=gsum(cols["l_extendedprice"]),
        avg_disc=gsum(cols["l_discount"]) / cnt,
    )
    return out


def oracle_q6(cols: dict):
    import numpy as np

    d = cols["l_shipdate"]
    disc = cols["l_discount"]
    keep = (
        (d >= 8766) & (d < 9131)  # [1994-01-01, 1995-01-01)
        & (disc >= 0.05) & (disc <= 0.07) & (cols["l_quantity"] < 24)
    )
    return {"revenue": np.array([np.sum(cols["l_extendedprice"][keep] * disc[keep])])}


def compare(name: str, got, want: dict) -> None:
    import numpy as np

    check(got.column_names == list(want), f"{name}: columns {got.column_names}")
    for c, w in want.items():
        a = got.column(c).to_pylist()
        check(len(a) == len(w), f"{name}.{c}: {len(a)} rows, oracle {len(w)}")
        if isinstance(w, np.ndarray) and w.dtype.kind == "f":
            check(
                np.allclose(np.asarray(a, dtype=np.float64), w, rtol=1e-9, atol=0.0),
                f"{name}.{c}: {a} vs oracle {w.tolist()}",
            )
        else:
            check(list(a) == list(w), f"{name}.{c}: {a} vs oracle {list(w)}")


# Device programs by kind, matched on the profiler's kernel names: the
# one-hot kernel, then the torch ops that stand in for the reference's
# jitted XLA programs (sort passes, gathers, searchsorted, prefix sums,
# scatters), then the rest.
DEVICE_KINDS = (
    ("onehot kernel", ("partial_sums", "reduce_partials", "owner_sums")),
    ("sort", ("sort", "radix")),
    ("searchsorted", ("searchsorted",)),
    ("cumsum", ("scan", "cumsum")),
    ("scatter", ("scatter", "index_put", "indexfunc", "index_add", "index_fill")),
    ("gather", ("index_elementwise", "gather", "index_select", "indexselect")),
    ("reduce", ("reduce",)),
    ("copy, cat, fill", ("memcpy", "memset", "copy", "cat", "fill")),
    ("elementwise", ("elementwise", "vectorized")),
)


def device_kind(name: str) -> str:
    low = name.lower()
    for kind, needles in DEVICE_KINDS:
        if any(n in low for n in needles):
            return kind
    return "other"


def profile_query(ctx, q: str, sql: str) -> dict:
    """One warm run under torch.profiler: wall time, device time summed over
    kernels (one stream, so kernels do not overlap), the device's idle share
    of the wall time, and the kernels with the most device time."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        _, plan = ctx.sql(sql).collect_with_plan()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
    log(f"{q} plan with host-side operator metrics:\n{plan.display(with_metrics=True)}")

    def dev_us(e):
        v = getattr(e, "self_device_time_total", None)
        return v if v is not None else getattr(e, "self_cuda_time_total", 0)

    # device-side rows only (kernels, copies, fills): the host-side aten::
    # rows carry the same device time again, attributed to the op
    events = [
        e for e in prof.key_averages()
        if getattr(e, "device_type", None) == DeviceType.CUDA and dev_us(e) > 0
    ]
    busy_s = sum(dev_us(e) for e in events) / 1e6
    top = sorted(events, key=dev_us, reverse=True)[:12]
    by_kind: dict = {}
    for e in events:
        k = device_kind(e.key)
        launches, ms = by_kind.get(k, (0, 0.0))
        by_kind[k] = (launches + e.count, ms + dev_us(e) / 1e3)
    res = {
        "wall_s": wall,
        "device_busy_s": busy_s,
        "device_idle_share": (1.0 - busy_s / wall) if busy_s else None,
        "top": [[e.key[:80], e.count, dev_us(e) / 1e3] for e in top],
        # [launches, device ms] of each kind of device program
        "by_kind": {k: list(v) for k, v in sorted(by_kind.items())},
    }
    log(f"{q} profile: {json.dumps(res)}")
    return res


def lineitem_columns(table) -> dict:
    """The lineitem columns of the q1, q6 and wide oracles, on the host."""
    import numpy as np

    cols = {}
    for c in ("l_quantity", "l_extendedprice", "l_discount", "l_tax"):
        cols[c] = table.column(c).to_numpy()
    cols["l_shipdate"] = table.column("l_shipdate").cast("int32").to_numpy()
    for c in ("l_returnflag", "l_linestatus", "l_shipmode", "l_shipinstruct"):
        cols[c] = host_strings(table.column(c))
    return cols


def host_strings(col):
    """A string column as a numpy unicode array, the same as
    ``np.asarray(col.to_pylist())`` for a column without nulls, through its
    dictionary (a few distinct values a column: fast at 6M rows)."""
    import numpy as np
    import pyarrow as pa

    if col.null_count:
        return np.asarray(col.to_pylist())
    enc = col.dictionary_encode().combine_chunks()
    return np.asarray(enc.dictionary.to_pylist())[enc.indices.to_numpy(zero_copy_only=False)]


def main_path(table, sf: float, warm: int, profile: bool, rec: LaunchRecorder) -> dict:
    import torch

    from ballista_tpu_torch.exec.context import TorchContext
    from ballista_tpu_torch.ops import onehot_agg

    cols = lineitem_columns(table)
    oracles = {"q1": oracle_q1(cols), "q6": oracle_q6(cols), "wide": oracle_wide(cols)}

    ctx = TorchContext(device="cuda")
    ctx.register_table("lineitem", table)
    queries = {
        q: (ROOT / "benchmarks" / "queries" / f"{q}.sql").read_text()
        for q in ("q1", "q6")
    }
    queries["wide"] = WIDE_SQL
    out = {}
    results: dict = {}  # query -> (SQL, last card result), for phase 10
    torch.cuda.reset_peak_memory_stats()
    onehot_agg.launches = 0  # main path starts here
    for q, sql in queries.items():
        rec.tag = q
        before = onehot_agg.launches
        t = time.perf_counter()
        res = ctx.sql(sql).collect()
        cold = time.perf_counter() - t
        cold_launches = onehot_agg.launches - before
        compare(q, res, oracles[q])
        warm_s = []
        for _ in range(warm):
            t = time.perf_counter()
            res = ctx.sql(sql).collect()
            torch.cuda.synchronize()
            warm_s.append(time.perf_counter() - t)
            compare(q, res, oracles[q])
        out[q] = dict(
            cold_s=cold, warm_s=warm_s, rows=res.num_rows,
            kernel_launches_cold_run=cold_launches,
        )
        results[q] = (sql, res)
        log(f"{q}: ok  {json.dumps(out[q])}")
    launches = onehot_agg.launches  # main path ends here
    rec.tag = None
    peak = torch.cuda.max_memory_allocated()
    capture_runs([rec], {q: (lambda sql=sql: ctx.sql(sql).collect()) for q, sql in queries.items()})
    if profile:
        for q, sql in queries.items():
            out[q]["profile"] = profile_query(ctx, q, sql)
    check(out["q1"]["kernel_launches_cold_run"] > 0, "q1 did not launch the kernel")
    check(out["wide"]["kernel_launches_cold_run"] > 0, "wide did not launch the kernel")
    if sf >= 1:
        check(
            out["q1"]["kernel_launches_cold_run"] >= 4,
            f"q1 launched the kernel {out['q1']['kernel_launches_cold_run']} "
            "times in one run; at SF>=1 it must launch at least 4",
        )
    log(f"main path: kernel launches {launches}, peak device memory "
        f"{peak} bytes ({peak / 2**30:.3f} GiB)")
    out["oracles"] = oracles
    out["results"] = results
    out["launches"] = launches
    out["peak_bytes"] = peak
    return out


# -- phase 5: joins and the sort-based aggregate ------------------------------

# q18 first: its subquery's 1.5M order keys (at SF=1) must overflow the
# default group capacity on its first run, before another query's retry has
# grown the context's capacity hint
JOIN_QUERIES = ("q18", "q3", "q4", "q5", "q10")


class host_columns(dict):
    """Every column of every table as numpy, converted at its first use:
    dates as int32 days, strings as numpy unicode arrays (the oracles read
    a few of the string columns; converting lineitem's comments alone took
    most of phase 5's oracle time)."""

    def __init__(self, data: dict) -> None:
        super().__init__()
        self._arrow = {c: t.column(c) for t in data.values() for c in t.column_names}

    def __missing__(self, c: str):
        import numpy as np
        import pyarrow as pa

        col = self._arrow[c]
        if pa.types.is_date32(col.type):
            v = col.cast(pa.int32()).to_numpy()
        elif pa.types.is_string(col.type) or pa.types.is_large_string(col.type):
            v = host_strings(col)
        else:
            v = col.to_numpy()
        self[c] = v
        return v


def _day(y: int, m: int, d: int) -> int:
    import datetime

    return (datetime.date(y, m, d) - datetime.date(1970, 1, 1)).days


def _dates(days):
    import datetime

    return [datetime.date(1970, 1, 1) + datetime.timedelta(days=int(d)) for d in days]


def _lookup(pk, fk):
    """Row of each foreign key ``fk`` in the table whose unique key column
    is ``pk``, and whether it is there."""
    import numpy as np

    order = np.argsort(pk, kind="stable")
    pos = np.searchsorted(pk[order], fk).clip(0, len(pk) - 1)
    row = order[pos]
    return row, pk[row] == fk


def _group_sum(keys, vals):
    """Sorted unique keys, the f64 sum of ``vals`` per key, and the first
    row of each key."""
    import numpy as np

    uniq, first, inv = np.unique(keys, return_index=True, return_inverse=True)
    out = np.zeros(len(uniq), dtype=np.float64)
    np.add.at(out, inv, vals.astype(np.float64))
    return uniq, out, first


def oracle_q3(h: dict) -> dict:
    import numpy as np

    cut = _day(1995, 3, 15)
    crow, cok = _lookup(h["c_custkey"], h["o_custkey"])
    o_ok = cok & (h["c_mktsegment"][crow] == "BUILDING") & (h["o_orderdate"] < cut)
    orow, lok = _lookup(h["o_orderkey"], h["l_orderkey"])
    keep = lok & o_ok[orow] & (h["l_shipdate"] > cut)
    rev = h["l_extendedprice"][keep] * (1 - h["l_discount"][keep])
    keys, sums, first = _group_sum(h["l_orderkey"][keep], rev)
    odate = h["o_orderdate"][orow[keep]][first]
    prio = h["o_shippriority"][orow[keep]][first]
    top = np.lexsort((odate, -sums))[:10]
    return {
        "l_orderkey": keys[top].tolist(),
        "revenue": sums[top],
        "o_orderdate": _dates(odate[top]),
        "o_shippriority": prio[top].tolist(),
    }


def oracle_q4(h: dict) -> dict:
    import numpy as np

    late = np.unique(h["l_orderkey"][h["l_commitdate"] < h["l_receiptdate"]])
    d = h["o_orderdate"]
    keep = (d >= _day(1993, 7, 1)) & (d < _day(1993, 10, 1)) & np.isin(h["o_orderkey"], late)
    prios, counts = np.unique(h["o_orderpriority"][keep], return_counts=True)
    return {"o_orderpriority": prios.tolist(), "order_count": counts.astype(np.int64)}


def oracle_q5(h: dict) -> dict:
    import numpy as np

    asia = h["r_regionkey"][h["r_name"] == "ASIA"]
    orow, lok = _lookup(h["o_orderkey"], h["l_orderkey"])
    d = h["o_orderdate"][orow]
    crow, cok = _lookup(h["c_custkey"], h["o_custkey"][orow])
    srow, sok = _lookup(h["s_suppkey"], h["l_suppkey"])
    snat = h["s_nationkey"][srow]
    nrow, nok = _lookup(h["n_nationkey"], snat)
    keep = (
        lok & cok & sok & nok
        & (d >= _day(1994, 1, 1)) & (d < _day(1995, 1, 1))
        & (h["c_nationkey"][crow] == snat)
        & np.isin(h["n_regionkey"][nrow], asia)
    )
    rev = h["l_extendedprice"][keep] * (1 - h["l_discount"][keep])
    names, sums, _ = _group_sum(h["n_name"][nrow[keep]], rev)
    order = np.argsort(-sums, kind="stable")
    return {"n_name": names[order].tolist(), "revenue": sums[order]}


def oracle_q10(h: dict) -> dict:
    import numpy as np

    orow, lok = _lookup(h["o_orderkey"], h["l_orderkey"])
    d = h["o_orderdate"][orow]
    keep = (
        lok & (d >= _day(1993, 10, 1)) & (d < _day(1994, 1, 1))
        & (h["l_returnflag"] == "R")
    )
    cust = h["o_custkey"][orow[keep]]
    rev = h["l_extendedprice"][keep] * (1 - h["l_discount"][keep])
    keys, sums, _ = _group_sum(cust, rev)
    top = np.lexsort((keys, -sums))[:20]
    crow, _ = _lookup(h["c_custkey"], keys[top])
    nrow, _ = _lookup(h["n_nationkey"], h["c_nationkey"][crow])
    return {
        "c_custkey": keys[top].tolist(),
        "c_name": h["c_name"][crow].tolist(),
        "revenue": sums[top],
        "c_acctbal": h["c_acctbal"][crow],
        "n_name": h["n_name"][nrow].tolist(),
        "c_address": h["c_address"][crow].tolist(),
        "c_phone": h["c_phone"][crow].tolist(),
        "c_comment": h["c_comment"][crow].tolist(),
    }


def oracle_q18(h: dict, threshold: int = 300) -> dict:
    import numpy as np

    keys, qty, _ = _group_sum(h["l_orderkey"], h["l_quantity"])
    big, big_qty = keys[qty > threshold], qty[qty > threshold]
    orow, ok = _lookup(h["o_orderkey"], big)
    crow, cok = _lookup(h["c_custkey"], h["o_custkey"][orow])
    sel = ok & cok
    big, big_qty, orow, crow = big[sel], big_qty[sel], orow[sel], crow[sel]
    price, odate = h["o_totalprice"][orow], h["o_orderdate"][orow]
    top = np.lexsort((odate, -price))[:100]
    return {
        "c_name": h["c_name"][crow[top]].tolist(),
        "c_custkey": h["c_custkey"][crow[top]].tolist(),
        "o_orderkey": big[top].tolist(),
        "o_orderdate": _dates(odate[top]),
        "o_totalprice": price[top],
        "SUM(l_quantity)": big_qty[top],
    }


def splitmix64_numpy(cols, nulls=None, tables=None) -> "np.ndarray":
    """``ops/hashing.hash_columns`` in numpy uint64 (wrapping arithmetic):
    the independent oracle of the partition-hash kernel and of the port's
    int64-emulated hash. Every NaN hashes as the positive quiet NaN. A
    column with a table (a string column's value hashes, uint64) hashes
    ``table[clip(code)]``; a null row (``nulls``) hashes 0, after the
    table."""
    import numpy as np

    c1, c2, c3 = (np.uint64(v) for v in (0x9E3779B97F4A7C15, 0xBF58476D1CE4E5B9, 0x94D049BB133111EB))

    def mix(x):
        x = x + c1
        x = (x ^ (x >> np.uint64(30))) * c2
        x = (x ^ (x >> np.uint64(27))) * c3
        return x ^ (x >> np.uint64(31))

    nulls = nulls or [None] * len(cols)
    tables = tables or [None] * len(cols)
    with np.errstate(over="ignore", invalid="ignore"):
        h = np.zeros(len(cols[0]), dtype=np.uint64)
        for c, m, t in zip(cols, nulls, tables):
            if t is not None:
                u = t[np.clip(c, 0, len(t) - 1)].astype(np.uint64)
            elif c.dtype.kind == "f":
                u = (c.astype(np.float32) + np.float32(0.0)).view(np.uint32).astype(np.uint64)
                u[np.isnan(c)] = 0x7FC00000
            else:
                u = c.astype(np.int64).view(np.uint64)
            if m is not None:
                u = np.where(m, np.uint64(0), u)
            h = mix(h ^ mix(u))
    return h


def hash_check(seed: int) -> dict:
    """``hash_columns`` on the card against the numpy uint64 oracle, on
    int64, f64 and f32 columns (alone and together) holding -0.0, NaNs with
    a sign bit or a payload (all of which must hash alike), +-inf and the
    int64 extremes, at n = 2^20. Every call goes through the partition-hash
    kernel's hash-only mode."""
    import numpy as np
    import torch

    from ballista_tpu_torch.ops import partition
    from ballista_tpu_torch.ops.hashing import hash_columns

    rng = np.random.default_rng(seed)
    n = 1 << 20
    before = partition.launches
    i64 = rng.integers(np.iinfo(np.int64).min, np.iinfo(np.int64).max, n, dtype=np.int64)
    i64[:4] = [np.iinfo(np.int64).min, np.iinfo(np.int64).max, 0, -1]
    f64 = rng.normal(0, 1e6, n)
    f64[:6] = [-0.0, 0.0, np.nan, np.inf, -np.inf, 1e300]
    # NaNs with the sign bit, a payload, and a signaling one
    f64[6:9] = np.array(
        [0xFFF8000000000000, 0x7FF8DEADBEEF0001, 0x7FF0000000000123], dtype=np.uint64
    ).view(np.float64)
    with np.errstate(over="ignore", invalid="ignore"):
        f32 = f64.astype(np.float32)
    cases = {"i64": [i64], "f64": [f64], "f32": [f32], "i64+f64": [i64, f64]}
    for tag, cols in cases.items():
        got = hash_columns([torch.from_numpy(c).cuda() for c in cols]).cpu().numpy()
        want = splitmix64_numpy(cols).view(np.int64)
        check(np.array_equal(got, want), f"hash {tag}: the card differs from the numpy uint64 oracle")
    check(
        len(set(hash_columns([torch.tensor([0.0, -0.0], device="cuda")]).tolist())) == 1,
        "hash: -0.0 and +0.0 hash differently",
    )
    nans = torch.from_numpy(f64[[2, 6, 7, 8]].copy()).cuda()
    check(len(set(hash_columns([nans]).tolist())) == 1, "hash: NaNs hash differently")
    # every call on the card went through the partition-hash kernel
    check(partition.launches - before == len(cases) + 2, "hash: a call did not launch the kernel")
    res = dict(n=n, cases=list(cases), kernel_launches=partition.launches - before, ok=True)
    log(f"hash: ok  {json.dumps(res)}")
    return res


def count_syncs(fn) -> tuple:
    """(``fn()``, the host-device synchronizations during it, as torch's
    sync debug mode reports them: one warning each)."""
    import warnings

    import torch

    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            out = fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    return out, sum("synchroniz" in str(w.message) for w in caught)


def decimal_check() -> dict:
    """The exact decimal sums on the card against the CPU, on
    ``tests/test_decimal_exact.py``'s money table: the first run (at the
    scales its device check picks) within rtol 1e-9, the third (int64 at
    the learned scales) bit for bit."""
    import numpy as np
    import pyarrow as pa

    from ballista_tpu_torch.config import BallistaConfig
    from ballista_tpu_torch.exec.context import TorchContext

    rng = np.random.default_rng(5)
    n = 50_000
    table = pa.table({
        "g": pa.array(rng.integers(0, 7, n).astype(np.int64)),
        "price": pa.array(np.round(rng.uniform(1, 10_000, n), 2)),
        "disc": pa.array(np.round(rng.uniform(0, 0.1, n), 2)),
        "qty": pa.array(np.round(rng.integers(1, 51, n).astype(np.float64), 2)),
    })
    sql = (
        "SELECT g, SUM(price) AS sp, SUM(price * (1 - disc)) AS srev, "
        "SUM(qty) AS sq, AVG(price) AS ap, COUNT(*) AS c FROM t GROUP BY g ORDER BY g"
    )
    runs = {}
    for dev in ("cpu", "cuda"):
        ctx = TorchContext(
            BallistaConfig({"ballista.shuffle.partitions": "1", "ballista.tpu.batch_rows": "4096"}),
            device=dev,
        )
        ctx.register_table("t", table)
        runs[dev] = [ctx.sql(sql).collect() for _ in range(3)]
    for c in ("sp", "srev", "sq", "ap"):
        first = [r[0].column(c).to_numpy() for r in (runs["cpu"], runs["cuda"])]
        check(np.allclose(first[1], first[0], rtol=1e-9, atol=0.0), f"decimal {c}: first run off")
    check(runs["cuda"][2].equals(runs["cpu"][2]), "decimal: the card's third run differs from the CPU's")
    first_equal = runs["cuda"][0].equals(runs["cpu"][0])
    res = dict(rows=n, first_run_bit_identical=first_equal, third_run_bit_identical=True)
    log(f"decimal: ok  {json.dumps(res)}")
    return res


def joins_path(
    data: dict, warm: int, profile: bool, rec: "LaunchRecorder", prec: "PartitionRecorder"
) -> dict:
    """q3, q4, q5, q10 and q18 through the port on the card against the
    numpy oracles; ``rec`` and ``prec`` keep the kernels' launch shapes and
    inputs."""
    import torch

    from ballista_tpu_torch.exec.context import TorchContext
    from ballista_tpu_torch.ops import onehot_agg, partition

    t0 = time.perf_counter()
    h = host_columns(data)
    oracles = {
        "q3": oracle_q3(h), "q4": oracle_q4(h), "q5": oracle_q5(h),
        "q10": oracle_q10(h), "q18": oracle_q18(h),
    }
    log(f"joins: oracles in {time.perf_counter() - t0:.1f}s; q18 selects "
        f"{len(oracles['q18']['o_orderkey'])} orders")

    ctx = TorchContext(device="cuda")
    for name, t in data.items():
        ctx.register_table(name, t)
    out = {}
    results: dict = {}  # query -> (SQL, last card result), for phase 10
    torch.cuda.reset_peak_memory_stats()
    launches = plaunches = 0
    for q in JOIN_QUERIES:
        sql = (ROOT / "benchmarks" / "queries" / f"{q}.sql").read_text()
        runs = []
        rec.tag = prec.tag = q
        for i in range(1 + warm):
            onehot_agg.launches = partition.launches = 0  # this query's run starts here
            t = time.perf_counter()
            df = ctx.sql(sql)
            res, syncs = count_syncs(df.collect)
            torch.cuda.synchronize()
            secs = time.perf_counter() - t
            launches += onehot_agg.launches
            plaunches += partition.launches
            runs.append(dict(
                s=secs, launches=onehot_agg.launches, plaunches=partition.launches,
                capacity_retries=df.stats.get("capacity_retries", 0),
                speculation_misses=df.stats.get("speculation_misses", 0),
                syncs=syncs, table=res,
            ))
            compare(f"{q} run {i}", res, oracles[q])
        if warm >= 2:
            check(
                runs[-1]["table"].equals(runs[-2]["table"]),
                f"{q}: two warm runs differ",
            )
        results[q] = (sql, runs[-1]["table"])
        out[q] = dict(
            cold_s=runs[0]["s"], warm_s=[r["s"] for r in runs[1:]],
            rows=runs[0]["table"].num_rows,
            kernel_launches=[r["launches"] for r in runs],
            capacity_retries=[r["capacity_retries"] for r in runs],
            speculation_misses=[r["speculation_misses"] for r in runs],
            host_syncs=[r["syncs"] for r in runs],
            kernel_shapes=sorted(set(rec.shapes.get(q, []))),
            partition_launches=[r["plaunches"] for r in runs],
            partition_shapes=sorted(set(prec.shapes.get(q, []))),
        )
        log(f"{q}: ok  {json.dumps(out[q])}")
    rec.tag = prec.tag = None
    peak = torch.cuda.max_memory_allocated()
    capture_runs([rec, prec], {
        q: (lambda q=q: ctx.sql((ROOT / "benchmarks" / "queries" / f"{q}.sql").read_text()).collect())
        for q in JOIN_QUERIES
    })
    check(out["q18"]["capacity_retries"][0] >= 1, "q18's first run did not retry after a capacity overflow")
    for q in ("q4", "q5"):
        check(min(out[q]["kernel_launches"]) > 0, f"{q} did not launch the one-hot kernel")
    log(f"joins: kernel launches {launches}, peak device memory {peak} bytes "
        f"({peak / 2**30:.3f} GiB)")
    if profile:
        for q in JOIN_QUERIES:
            sql = (ROOT / "benchmarks" / "queries" / f"{q}.sql").read_text()
            out[q]["profile"] = profile_query(ctx, q, sql)
    out["oracles"] = oracles
    out["results"] = results
    out["launches"] = launches
    out["partition_launches"] = plaunches
    out["peak_bytes"] = peak
    out["ctx"] = ctx  # phase 20 (a) runs on it, then drops it
    return out


# -- phase 6: the rest of TPC-H, a window and a percentile query ------------

# every TPC-H query the phases above do not run
REST_QUERIES = (
    "q2", "q7", "q8", "q9", "q11", "q12", "q13", "q14", "q15", "q16", "q17",
    "q19", "q20", "q21", "q22",
)
# a ranking function and running frame aggregates partitioned by customer,
# in the forms of tests/test_window_functions.py and test_window_aggregates.py
WINDOW_SQL = (
    "select o_orderkey, o_custkey, "
    "row_number() over (partition by o_custkey order by o_orderdate, o_orderkey) as rn, "
    "rank() over (partition by o_custkey order by o_orderpriority) as rk, "
    "sum(o_totalprice) over (partition by o_custkey order by o_orderdate "
    "rows unbounded preceding) as running_total, "
    "max(o_totalprice) over (partition by o_custkey order by o_orderdate "
    "rows unbounded preceding) as running_max from orders"
)
# over lineitem with its spec's NOT NULL columns: a nullable string group
# key would need a string-valued CASE in the percentile split, which neither
# the reference nor the port has on the device
PERCENTILE_SQL = (
    "select l_returnflag, median(l_extendedprice) as med_price, "
    "approx_percentile_cont(l_discount, 0.9) as p90_discount, count(*) as c "
    "from lineitem group by l_returnflag order by l_returnflag"
)
# money sums of the sort-based aggregate: exact decimals in every run, so the
# card's third run equals the CPU's run bit for bit
MONEY_SUMS = {
    "q7": ("revenue",), "q8": ("mkt_share",), "q9": ("sum_profit",),
    "q11": ("value",), "q15": ("total_revenue",),
}


def compare_tables(name: str, got, want) -> None:
    """Schema, keys, counts and row order exactly; floats within rtol 1e-9,
    with their nulls in the same rows."""
    import numpy as np
    import pyarrow as pa

    check(got.schema.equals(want.schema), f"{name}: schema {got.schema} vs {want.schema}")
    check(got.num_rows == want.num_rows, f"{name}: {got.num_rows} rows, the CPU {want.num_rows}")
    for c in want.column_names:
        g, w = got.column(c), want.column(c)
        if not pa.types.is_floating(w.type):
            check(g.equals(w), f"{name}.{c} differs from the CPU's")
            continue
        check(
            np.array_equal(g.is_null().to_numpy(), w.is_null().to_numpy()),
            f"{name}.{c}: nulls in other rows than the CPU's",
        )
        a, b = g.fill_null(0.0).to_numpy(), w.fill_null(0.0).to_numpy()
        ok = np.isclose(a, b, rtol=1e-9, atol=0.0, equal_nan=True)
        if not ok.all():
            rel = np.abs(a - b)[~ok] / np.maximum(np.abs(b[~ok]), 1e-300)
            raise SmokeFailure(f"{name}.{c}: off the CPU's by up to {rel.max():.3e} relative")


def selects_rows(t) -> bool:
    """Rows, and not only the NULL row of an aggregate over nothing."""
    return t.num_rows > 0 and t.column(t.num_columns - 1).null_count < t.num_rows


def rest_jobs() -> list:
    """Phase 6's queries: (name, SQL, over lineitem with NOT NULL columns)."""
    jobs = [(q, (ROOT / "benchmarks" / "queries" / f"{q}.sql").read_text(), False) for q in REST_QUERIES]
    return jobs + [("window", WINDOW_SQL, False), ("percentile", PERCENTILE_SQL, True)]


def not_null_lineitem(li):
    import pyarrow as pa

    return li.cast(pa.schema([f.with_nullable(False) for f in li.schema]))


def cpu_reference(pkg_root: str, tables_dir: str, out_dir: str) -> None:
    """Phase 6's CPU runs, in a process of their own that ``main`` starts
    before phase 3 (``CpuReference``): the tables from ``tables_dir`` (Arrow
    IPC files), each of ``rest_jobs()`` once through
    ``TorchContext(device="cpu")`` (the port's plain path); a query whose
    spec constants select nothing runs again with constants chosen from
    the data, as tests/test_tpch_oracle.py does at SF=0.002. Each result
    goes to ``out_dir/<q>.arrow``, its SQL, seconds and substitution to
    ``out_dir/<q>.json``."""
    import traceback

    sys.path.insert(0, pkg_root)
    try:
        import pyarrow as pa

        from ballista_tpu_torch.exec.context import TorchContext
        from ballista_tpu_torch.tpch import spec_substitutions

        data = {
            p.stem: pa.ipc.open_file(pa.memory_map(str(p))).read_all()
            for p in sorted(pathlib.Path(tables_dir).glob("*.arrow"))
        }
        cpu, cpu_nn = TorchContext(device="cpu"), TorchContext(device="cpu")
        for name, t in data.items():
            cpu.register_table(name, t)
        cpu_nn.register_table("lineitem", not_null_lineitem(data["lineitem"]))
        for q, sql, nn in rest_jobs():
            on_cpu = cpu_nn if nn else cpu
            t = time.perf_counter()
            want = on_cpu.sql(sql).collect()
            cpu_s = time.perf_counter() - t
            subst = {}
            if not selects_rows(want):
                subst = spec_substitutions(q, data) if q in REST_QUERIES else {}
                check(bool(subst), f"{q}: selects no rows")
                for old, new in subst.items():
                    sql = sql.replace(old, new)
                t = time.perf_counter()
                want = on_cpu.sql(sql).collect()
                cpu_s = time.perf_counter() - t
                check(selects_rows(want), f"{q}: selects no rows, even with {subst}")
            with pa.OSFile(str(pathlib.Path(out_dir) / f"{q}.arrow"), "wb") as f:
                with pa.ipc.new_file(f, want.schema) as w:
                    w.write_table(want)
            (pathlib.Path(out_dir) / f"{q}.json").write_text(
                json.dumps({"sql": sql, "cpu_s": cpu_s, "subst": subst})
            )
    except BaseException:
        (pathlib.Path(out_dir) / "error.txt").write_text(traceback.format_exc())
        raise


class CpuReference:
    """Runs ``cpu_reference`` in a spawned process (it never touches the
    card) over the tables written as Arrow IPC into a temporary directory,
    side by side with the phases before 6; ``result(q)`` waits for it.
    ``close`` stops the process if it still runs and deletes the files."""

    def __init__(self, data: dict, pkg_root: pathlib.Path) -> None:
        import multiprocessing
        import tempfile

        import pyarrow as pa

        self.dir = pathlib.Path(tempfile.mkdtemp(prefix="chip_smoke_cpu-"))
        (self.dir / "tables").mkdir()
        (self.dir / "out").mkdir()
        for name, t in data.items():
            with pa.OSFile(str(self.dir / "tables" / f"{name}.arrow"), "wb") as f:
                with pa.ipc.new_file(f, t.schema) as w:
                    w.write_table(t)
        self.t0 = time.perf_counter()
        self.proc = multiprocessing.get_context("spawn").Process(
            target=cpu_reference,
            args=(str(pkg_root), str(self.dir / "tables"), str(self.dir / "out")),
            daemon=True,
        )
        self.proc.start()
        self.waited_s = None

    def result(self, q: str):
        """(SQL, the CPU's result, its seconds, the substitution)."""
        import pyarrow as pa

        if self.waited_s is None:
            t = time.perf_counter()
            self.proc.join(timeout=600)
            self.waited_s = time.perf_counter() - t
            err = self.dir / "out" / "error.txt"
            check(self.proc.exitcode == 0,
                  f"CPU reference process: exit {self.proc.exitcode}\n"
                  + (err.read_text() if err.exists() else ""))
            log(f"rest: CPU reference process done {time.perf_counter() - self.t0:.1f}s after its "
                f"start; phase 6 waited {self.waited_s:.1f}s for it")
        meta = json.loads((self.dir / "out" / f"{q}.json").read_text())
        want = pa.ipc.open_file(pa.memory_map(str(self.dir / "out" / f"{q}.arrow"))).read_all()
        return meta["sql"], want, meta["cpu_s"], meta["subst"]

    def close(self) -> None:
        import shutil

        if self.proc.is_alive():
            self.proc.terminate()
            self.proc.join(timeout=30)
        shutil.rmtree(self.dir, ignore_errors=True)


def rest_path(
    data: dict, warm: int, profile: bool, rec: "LaunchRecorder", prec: "PartitionRecorder",
    cpu: CpuReference,
) -> dict:
    """The TPC-H queries not yet on the card, the window query and the
    percentile query: each once on the CPU (the port's plain path, in the
    ``cpu`` process), then cold and ``warm`` times on the card, every card
    run held against the CPU's result."""
    import pyarrow as pa
    import torch

    from ballista_tpu_torch.exec.context import TorchContext
    from ballista_tpu_torch.ops import onehot_agg, partition

    card = TorchContext(device="cuda")
    for name, t in data.items():
        card.register_table(name, t)
    card_nn = TorchContext(device="cuda")
    card_nn.register_table("lineitem", not_null_lineitem(data["lineitem"]))
    out: dict = {}
    sqls: dict = {}
    results: dict = {}  # query -> (SQL, the card's third run), for phase 10
    torch.cuda.reset_peak_memory_stats()
    launches = plaunches = 0
    for q, _, nn in rest_jobs():
        on_card = card_nn if nn else card
        sql, want, cpu_s, subst = cpu.result(q)
        sqls[q] = (sql, on_card)
        runs = []
        rec.tag = prec.tag = q
        for i in range(1 + warm):
            onehot_agg.launches = partition.launches = 0  # this query's run starts here
            t = time.perf_counter()
            df = on_card.sql(sql)
            res, syncs = count_syncs(df.collect)
            torch.cuda.synchronize()
            secs = time.perf_counter() - t
            launches += onehot_agg.launches
            plaunches += partition.launches
            runs.append(dict(
                s=secs, launches=onehot_agg.launches, plaunches=partition.launches,
                capacity_retries=df.stats.get("capacity_retries", 0),
                speculation_misses=df.stats.get("speculation_misses", 0),
                syncs=syncs, table=res,
            ))
            compare_tables(f"{q} run {i}", res, want)
        a, b = runs[-1]["table"], runs[-2]["table"]
        check(
            a.equals(b),
            f"{q}: two warm runs differ in "
            f"{[c for c in a.column_names if not a.column(c).equals(b.column(c))]}",
        )
        check(
            all(r["capacity_retries"] == r["speculation_misses"] == 0 for r in runs[1:]),
            f"{q}: a warm run retried",
        )
        third = runs[2]["table"]
        for c in MONEY_SUMS.get(q, ()):
            check(
                third.column(c).equals(want.column(c)),
                f"{q}.{c}: the card's third run differs from the CPU's",
            )
        results[q] = (sql, third)
        out[q] = dict(
            cold_s=runs[0]["s"], warm_s=[r["s"] for r in runs[1:]], cpu_s=cpu_s,
            rows=want.num_rows, substituted=subst,
            kernel_launches=[r["launches"] for r in runs],
            capacity_retries=[r["capacity_retries"] for r in runs],
            speculation_misses=[r["speculation_misses"] for r in runs],
            host_syncs=[r["syncs"] for r in runs],
            kernel_shapes=sorted(set(rec.shapes.get(q, []))),
            partition_launches=[r["plaunches"] for r in runs],
            partition_shapes=sorted(set(prec.shapes.get(q, []))),
            # float columns of the third run equal to the CPU's bit for bit
            float_bit_identical={
                c: third.column(c).equals(want.column(c))
                for c in want.column_names if pa.types.is_floating(want.schema.field(c).type)
            },
        )
        log(f"{q}: ok  {json.dumps(out[q])}")
    rec.tag = prec.tag = None
    peak = torch.cuda.max_memory_allocated()
    for q in ("q12", "q22"):
        check(min(out[q]["kernel_launches"]) > 0, f"{q} did not launch the one-hot kernel")
    log(f"rest: kernel launches {launches}, peak device memory {peak} bytes "
        f"({peak / 2**30:.3f} GiB)")
    capture_runs([rec, prec], {
        q: (lambda s=s, c=c: c.sql(s).collect()) for q, (s, c) in sqls.items()
    })
    if profile:
        for q, (sql, on_card) in sqls.items():
            out[q]["profile"] = profile_query(on_card, q, sql)
    out["results"] = results
    out["launches"] = launches
    out["partition_launches"] = plaunches
    out["peak_bytes"] = peak
    return out


# -- phase 7: hash repartition and grace-hash spill ---------------------------

GRACE_QUERIES = ("q3", "q5", "q18")
# device budget of phase 7 (MB): small enough that a join of each of q3, q5
# and q18 (and q18's subquery aggregate) spills at SF=1
GRACE_BUDGET_MB = 16
DIST_QUERIES = ("q1", "q12", "q3")
# the sort path's money sums (exact decimals): bit for bit under the budget;
# q5's revenue goes through the dense path's f64 sums, whose order of adds
# the grace passes change
GRACE_EXACT = {"q3": ("revenue",), "q18": ("SUM(l_quantity)",)}


def grace_path(data: dict, rec: LaunchRecorder, prec: PartitionRecorder) -> dict:
    """q3, q5 and q18 under ``ballista.tpu.hbm_budget_mb`` on the card (q5
    one cold and one warm run, q3 and q18 one run), held against the same query's unbudgeted
    card run; then q1, q12 and q3 from the distributed planner (K = 4)
    executed in process on the card, held against collect mode."""
    import os

    import pyarrow as pa
    import torch

    from ballista_tpu_torch.columnar.arrow_interop import batch_to_arrow
    from ballista_tpu_torch.config import BallistaConfig
    from ballista_tpu_torch.exec.base import (
        execute_to_batches,
        plan_counters,
        run_with_capacity_retry,
    )
    from ballista_tpu_torch.exec.context import TorchContext
    from ballista_tpu_torch.exec.planner import PhysicalPlanner
    from ballista_tpu_torch.exec import spill
    from ballista_tpu_torch.exec.spill import SPILL_TMP_ROOT
    from ballista_tpu_torch.ops import onehot_agg, partition
    from ballista_tpu_torch.plan.optimizer import optimize

    sqls = {
        q: (ROOT / "benchmarks" / "queries" / f"{q}.sql").read_text()
        for q in dict.fromkeys(GRACE_QUERIES + DIST_QUERIES)
    }
    # the yardstick: each query once, unbudgeted, in collect mode
    t = time.perf_counter()
    card = TorchContext(device="cuda")
    for name, tab in data.items():
        card.register_table(name, tab)
    want = {q: card.sql(sql).collect() for q, sql in sqls.items()}
    ref_s = time.perf_counter() - t
    log(f"grace: unbudgeted references in {ref_s:.1f}s")

    dirs = lambda: set(os.listdir(SPILL_TMP_ROOT)) if os.path.isdir(SPILL_TMP_ROOT) else set()  # noqa: E731
    before = dirs()
    ctx = TorchContext(
        BallistaConfig({"ballista.tpu.hbm_budget_mb": str(GRACE_BUDGET_MB)}), device="cuda"
    )
    for name, tab in data.items():
        ctx.register_table(name, tab)
    out: dict = {}
    launches = plaunches = glaunches = 0
    torch.cuda.reset_peak_memory_stats()
    for q in GRACE_QUERIES:
        tag = f"{q}-budget"
        runs = []
        rec.tag = prec.tag = tag
        # q18 spills for some 20 s a run: one run (held against the
        # unbudgeted run like the others)
        n_runs = 1 if q in ("q18", "q3") else 2
        for i in range(n_runs):
            # the last run keeps the inputs of its first launch at each
            # shape (device copies, no sync) for the replays: a capture run
            # of its own would cost a spilling run more
            rec.keep = prec.keep = i == n_runs - 1
            seen = (len(rec.shapes.get(tag, [])), len(prec.shapes.get(tag, [])))
            # this run starts here
            onehot_agg.launches = partition.launches = partition.group_launches = 0
            spill.reset_stats()
            t = time.perf_counter()
            df = ctx.sql(sqls[q])
            (res, plan), syncs = count_syncs(df.collect_with_plan)
            torch.cuda.synchronize()
            secs = time.perf_counter() - t
            launches += onehot_agg.launches
            plaunches += partition.launches
            glaunches += partition.group_launches
            spilled = plan_counters(plan, ("spill_bytes", "spill_passes"))
            runs.append(dict(
                s=secs, launches=onehot_agg.launches, plaunches=partition.launches,
                glaunches=partition.group_launches,
                capacity_retries=df.stats.get("capacity_retries", 0), syncs=syncs,
                write=dict(spill.stats), **spilled,
            ))
            # the spill write waits on the card once a spilled batch, and
            # groups every spilled batch with the kernel
            check(
                spill.stats["waits"] == spill.stats["batches"] == partition.group_launches > 0,
                f"{tag} run {i}: {spill.stats['waits']} waits, {partition.group_launches} grouped "
                f"launches for {spill.stats['batches']} spilled batches",
            )
            compare_tables(f"{tag} run {i}", res, want[q])
            for c in GRACE_EXACT.get(q, ()):
                check(res.column(c).equals(want[q].column(c)), f"{tag} run {i}: {c} not bit for bit")
            check(
                spilled["spill_passes"] >= 2 and spilled["spill_bytes"] > 0,
                f"{tag} run {i}: no grace passes ({spilled})",
            )
        rec.keep = prec.keep = False
        for r, n0 in zip((rec, prec), seen):
            missing = set(r.shapes.get(tag, [])[n0:]) - set(r.inputs)
            check(not missing, f"{tag}: the warm run kept no input at shapes {sorted(missing)}")
        out[tag] = dict(
            cold_s=runs[0]["s"], warm_s=[r["s"] for r in runs[1:]], rows=want[q].num_rows,
            spill_bytes=[r["spill_bytes"] for r in runs],
            spill_passes=[r["spill_passes"] for r in runs],
            partition_launches=[r["plaunches"] for r in runs],
            grouped_launches=[r["glaunches"] for r in runs],
            partition_shapes=sorted(set(prec.shapes.get(tag, []))),
            onehot_launches=[r["launches"] for r in runs],
            onehot_shapes=sorted(set(rec.shapes.get(tag, []))),
            capacity_retries=[r["capacity_retries"] for r in runs],
            host_syncs=[r["syncs"] for r in runs],
            spill_waits=[r["write"]["waits"] for r in runs],
            # the spill write's split: device ms of the grouping and gathers
            # and of the copy (CUDA events), host s of queueing them, of the
            # wait, of the Arrow build and of the IPC writes
            spill_write=[r["write"] for r in runs],
        )
        log(f"{tag}: ok  {json.dumps(out[tag])}")
    rec.tag = prec.tag = None
    peak = torch.cuda.max_memory_allocated()
    check(not dirs() - before, f"grace: attempt directories left in {SPILL_TMP_ROOT}")
    check(min(out["q5-budget"]["onehot_launches"]) > 0, "q5-budget did not launch the one-hot kernel")
    check(
        any(r == 2 for _, r, _ in out["q5-budget"]["onehot_shapes"]),
        "q5-budget's partial aggregates did not launch the one-hot kernel at R = 2",
    )
    for q in GRACE_QUERIES:
        check(min(out[f"{q}-budget"]["partition_launches"]) > 0, f"{q}-budget routed no row by the kernel")
    log(f"grace: peak device memory {peak} bytes ({peak / 2**30:.3f} GiB) under a "
        f"{GRACE_BUDGET_MB} MB budget")

    # the distributed planner's trees, in process on the card
    plans = {
        q: PhysicalPlanner(card, 4, config=card.config, distributed=True).plan(
            optimize(card.sql_to_logical(sqls[q]))
        )
        for q in DIST_QUERIES
    }

    def run_tree(q: str):
        def run(task):
            return [rb for b in execute_to_batches(plans[q], task) if (rb := batch_to_arrow(b)).num_rows]

        return pa.Table.from_batches(run_with_capacity_retry(card.config, run, device="cuda"))

    torch.cuda.reset_peak_memory_stats()
    for q in DIST_QUERIES:
        tag = f"{q}-dist"
        text = plans[q].display()
        check("HashRepartitionExec" in text, f"{tag}: no hash repartition in the plan")
        if q in ("q12", "q3"):
            check("partitioned" in text, f"{tag}: no partitioned join in the plan")
        rec.tag = prec.tag = tag
        runs = []
        for i in range(2):
            # this run starts here
            onehot_agg.launches = partition.launches = partition.group_launches = 0
            t = time.perf_counter()
            res, syncs = count_syncs(lambda q=q: run_tree(q))
            torch.cuda.synchronize()
            secs = time.perf_counter() - t
            launches += onehot_agg.launches
            plaunches += partition.launches
            glaunches += partition.group_launches
            runs.append(dict(s=secs, launches=onehot_agg.launches, plaunches=partition.launches, syncs=syncs))
            compare_tables(f"{tag} run {i}", res, want[q])
        out[tag] = dict(
            cold_s=runs[0]["s"], warm_s=[r["s"] for r in runs[1:]], rows=want[q].num_rows,
            partition_launches=[r["plaunches"] for r in runs],
            partition_shapes=sorted(set(prec.shapes.get(tag, []))),
            onehot_launches=[r["launches"] for r in runs],
            host_syncs=[r["syncs"] for r in runs],
            plan=text.splitlines(),
        )
        log(f"{tag}: ok  {json.dumps(out[tag])}")
        check(min(out[tag]["partition_launches"]) > 0, f"{tag} routed no row by the kernel")
    rec.tag = prec.tag = None
    dist_peak = torch.cuda.max_memory_allocated()
    log(f"grace: distributed trees' peak device memory {dist_peak} bytes ({dist_peak / 2**30:.3f} GiB)")
    capture_runs([rec, prec], {f"{q}-dist": (lambda q=q: run_tree(q)) for q in DIST_QUERIES})
    check(not dirs() - before, f"grace: attempt directories left in {SPILL_TMP_ROOT}")
    out["launches"] = launches
    out["partition_launches"] = plaunches
    out["grouped_launches"] = glaunches
    out["peak_bytes"] = peak
    out["dist_peak_bytes"] = dist_peak
    out["reference_s"] = ref_s
    return out


# -- phase 8: the staged path (plans across the wire, shuffle files) ----------

# phases 8, 9 and 13 (b); q18 runs on the distributed tier in phase 10 (the
# port's cluster, against the collect mode and the oracle) and 11 (e)
STAGED_QUERIES = ("q1", "q3", "q5", "q12")
STAGED_K = 4
# the sort path's money sums (exact decimals): bit for bit against collect
# mode; q1's and q5's sums go through the dense path's f64 sums, whose
# order of adds a staged plan changes
STAGED_EXACT = {"q3": ("revenue",), "q18": ("SUM(l_quantity)",)}


def run_staged(ctx, sql: str, work_dir: str, plan_cache: dict, k: int = STAGED_K, job_id: str = "job"):
    """One query as stages, in the scheduler's part: plan it for the
    distributed tier (K partitions), split it into stages, send each
    stage's plan through proto bytes (its decoded display must equal the
    encoded one's), resolve its inputs to the files the stages before it
    wrote, and run one task an input partition on the card, each writing
    its shuffle files under ``work_dir``. Returns the terminal stage's files
    as one table, and (stages, tasks, files, bytes written)."""
    import pyarrow as pa

    from ballista_tpu_torch.columnar.arrow_interop import schema_to_arrow
    from ballista_tpu_torch.config import BallistaConfig
    from ballista_tpu_torch.distributed_plan import DistributedPlanner, remove_unresolved_shuffles
    from ballista_tpu_torch.exec.base import run_with_capacity_retry
    from ballista_tpu_torch.exec.planner import PhysicalPlanner
    from ballista_tpu_torch.executor.reader import fetch_partition_table
    from ballista_tpu_torch.plan.optimizer import optimize
    from ballista_tpu_torch.proto import pb
    from ballista_tpu_torch.scheduler_types import PartitionLocation, PartitionStats
    from ballista_tpu_torch.serde import BallistaCodec

    cfg = BallistaConfig({"ballista.shuffle.partitions": str(k)})
    plan = PhysicalPlanner(ctx, k, config=cfg, distributed=True).plan(optimize(ctx.sql_to_logical(sql)))
    stages = DistributedPlanner().plan_query_stages(job_id, plan)
    codec = BallistaCodec(provider=ctx)
    locations: dict = {}
    tasks = files = nbytes = 0
    for stage in stages:
        wire = codec.physical_to_proto(stage.plan).SerializeToString()
        decoded = codec.physical_from_proto(pb.PhysicalPlanNode.FromString(wire))
        check(decoded.display() == stage.plan.display(), f"stage {stage.stage_id}: decoded plan differs")
        task = remove_unresolved_shuffles(decoded, locations)
        parts = [[] for _ in range(stage.output_partition_count)]
        for p in range(stage.input_partition_count):
            metas = run_with_capacity_retry(
                cfg, lambda c: task.execute_shuffle_write(p, c), device="cuda",
                plan_cache=plan_cache, work_dir=work_dir, job_id=job_id,
            )
            tasks += 1
            for m in metas:
                files += 1
                nbytes += m.num_bytes
                parts[m.partition_id].append(PartitionLocation(
                    job_id, stage.stage_id, m.partition_id, "local", "localhost", 0, m.path,
                    PartitionStats(m.num_rows, m.num_batches, m.num_bytes), map_partition=p,
                ))
        locations[stage.stage_id] = parts
    tables = [fetch_partition_table(loc) for part in locations[stages[-1].stage_id] for loc in part]
    result = pa.concat_tables(tables) if tables else schema_to_arrow(plan.schema()).empty_table()
    return result, dict(stages=len(stages), tasks=tasks, files=files, bytes=nbytes)


def staged_path(data: dict, oracles: dict, rec: LaunchRecorder, prec: PartitionRecorder) -> dict:
    """q1, q3, q5, q12 and q18 through the staged path on the card, one
    cold and two warm runs each, held against collect mode on the card and
    (q1, q3, q5, q18) against the numpy oracles of phases 4 and 5."""
    import os
    import tempfile

    import torch

    from ballista_tpu_torch.exec import spill
    from ballista_tpu_torch.exec.context import TorchContext
    from ballista_tpu_torch.executor import reader, shuffle
    from ballista_tpu_torch.ops import onehot_agg, partition

    ctx = TorchContext(device="cuda")
    for name, tab in data.items():
        ctx.register_table(name, tab)
    sqls = {q: (ROOT / "benchmarks" / "queries" / f"{q}.sql").read_text() for q in STAGED_QUERIES}
    out: dict = {}
    caches: dict = {}
    launches = plaunches = glaunches = 0
    torch.cuda.reset_peak_memory_stats()
    for q in STAGED_QUERIES:
        tag = f"{q}-stages"
        # collect mode on the same tables, cold and warm: the yardstick
        rec.tag = prec.tag = None
        collect_s = []
        for _ in range(2):
            t = time.perf_counter()
            want = ctx.sql(sqls[q]).collect()
            torch.cuda.synchronize()
            collect_s.append(time.perf_counter() - t)
        if q in oracles:
            compare(f"{tag} collect", want, oracles[q])
        rec.tag = prec.tag = tag
        cache = caches[q] = {}  # the plan cache an executor keeps across its tasks
        runs = []
        for i in range(3):
            # this run starts here
            onehot_agg.launches = partition.launches = partition.group_launches = 0
            spill.reset_stats(shuffle.stats)
            reader.reset_stats()
            with tempfile.TemporaryDirectory(prefix="ballista_stages-") as work:
                t = time.perf_counter()
                (res, info), syncs = count_syncs(lambda: run_staged(ctx, sqls[q], work, cache))
                torch.cuda.synchronize()
                secs = time.perf_counter() - t
            check(not os.path.exists(work), f"{tag}: work directory {work} left behind")
            launches += onehot_agg.launches
            plaunches += partition.launches
            glaunches += partition.group_launches
            runs.append(dict(
                s=secs, table=res, syncs=syncs, launches=onehot_agg.launches,
                plaunches=partition.launches, glaunches=partition.group_launches,
                write=dict(shuffle.stats), read=dict(reader.stats), **info,
            ))
            compare_tables(f"{tag} run {i}", res, want)
            for c in STAGED_EXACT.get(q, ()):
                check(res.column(c).equals(want.column(c)), f"{tag} run {i}: {c} not bit for bit")
            if q in oracles:
                compare(f"{tag} run {i}", res, oracles[q])
            check(
                shuffle.stats["waits"] == shuffle.stats["batches"] == partition.group_launches > 0,
                f"{tag} run {i}: {shuffle.stats['waits']} waits, {partition.group_launches} grouped "
                f"launches for {shuffle.stats['batches']} hash-partitioned batches",
            )
        check(runs[1]["table"].equals(runs[2]["table"]), f"{tag}: two warm runs differ")
        warm = runs[1:]
        out[tag] = dict(
            stages=runs[0]["stages"], tasks=runs[0]["tasks"], files=[r["files"] for r in runs],
            shuffle_mb=[r["bytes"] / 2**20 for r in runs], rows=want.num_rows,
            cold_s=runs[0]["s"], warm_s=[r["s"] for r in warm],
            collect_cold_s=collect_s[0], collect_warm_s=collect_s[1],
            grouped_launches=[r["glaunches"] for r in runs],
            partition_launches=[r["plaunches"] for r in runs],
            onehot_launches=[r["launches"] for r in runs],
            partition_shapes=sorted(set(prec.shapes.get(tag, []))),
            onehot_shapes=sorted(set(rec.shapes.get(tag, []))),
            host_syncs=[r["syncs"] for r in runs],
            # the write split: device ms of the grouping and gathers and of
            # the copy (CUDA events), host s of the Arrow build and of the
            # IPC writes (with the unpartitioned stages' copies); waits on
            # the card, one a hash-partitioned batch
            write=[{k: r["write"][k] for k in ("batches", "waits", "group_ms", "copy_ms", "arrow_s", "ipc_s")}
                   for r in warm],
            # the read split: host s of the IPC reads and of the uploads
            read=[r["read"] for r in warm],
        )
        log(f"{tag}: ok  {json.dumps(out[tag])}")
    rec.tag = prec.tag = None
    peak = torch.cuda.max_memory_allocated()
    for q in STAGED_QUERIES:
        check(min(out[f"{q}-stages"]["grouped_launches"]) > 0, f"{q}-stages: no grouped launch")
    check(min(out["q1-stages"]["onehot_launches"]) > 0, "q1-stages did not launch the one-hot kernel")
    log(f"stages: peak device memory {peak} bytes ({peak / 2**30:.3f} GiB)")

    def capture(q):
        # once with an empty plan cache, as the cold run, and once with the
        # warm runs' cache: a site that shrinks several batches decides each
        # batch's capacity on the cold run and takes their largest warm
        # (exec/shrink.py), so the two can launch at different shapes
        for cache in ({}, caches[q]):
            with tempfile.TemporaryDirectory(prefix="ballista_stages-") as work:
                run_staged(ctx, sqls[q], work, cache)

    capture_runs([rec, prec], {f"{q}-stages": (lambda q=q: capture(q)) for q in STAGED_QUERIES})
    out["launches"] = launches
    out["partition_launches"] = plaunches
    out["grouped_launches"] = glaunches
    out["peak_bytes"] = peak
    return out

# -- phase 9: the executor fleet (task runner, Flight, the process entry) ------

FLEET_QUERIES = STAGED_QUERIES
FLEET_K = STAGED_K
# the session of the fleet's jobs: every shuffle read crosses Flight; eager
# and push shuffle need a scheduler that publishes locations, which the
# stand-in does not (phase 10 runs them on the port's scheduler)
FLEET_SETTINGS = {
    "ballista.shuffle.partitions": str(FLEET_K),
    "ballista.tpu.shuffle_local_fastpath": "false",
    "ballista.tpu.eager_shuffle": "false",
    "ballista.tpu.push_shuffle": "false",
}
FLEET_METHODS = ("RegisterExecutor", "HeartBeatFromExecutor", "PollWork", "UpdateTaskStatus")


class StandInScheduler:
    """The scheduler's part in phase 9, small on purpose: it isolates the
    executors from the port's scheduler, which phase 10 runs. Registered through
    the port's ``scheduler/rpc.add_service``, it answers RegisterExecutor,
    HeartBeatFromExecutor, PollWork and UpdateTaskStatus. ``run_job`` plans
    a query for the distributed tier (K partitions) and splits it into
    stages as ``run_staged`` does; it hands out a stage's TaskDefinitions
    (proto bytes of the stage plan, its inputs resolved to the locations
    the earlier stages' statuses reported) once the stages before it have
    completed. Each executor that polls may take at most its share of a
    stage's tasks, so that every multi-task stage runs on both."""

    def __init__(self) -> None:
        import collections
        import threading

        self.cond = threading.Condition()
        self.pending = collections.deque()  # TaskDefinitions not handed out yet
        self.taken: dict = {}  # (job, stage, executor id) -> tasks taken
        self.done: dict = {}  # (job, stage, partition) -> (executor id, CompletedTask)
        self.failed: list = []
        self.executors: dict = {}  # id -> ExecutorMetadata of polling executors
        self.registered: dict = {}  # id -> ExecutorMetadata of RegisterExecutor
        self.heartbeats = collections.Counter()
        self.polls = collections.Counter()
        self.stage_tasks: dict = {}  # (job, stage) -> tasks
        self.server = None
        self.port = 0

    def start(self) -> int:
        from concurrent.futures import ThreadPoolExecutor

        import grpc

        from ballista_tpu_torch.scheduler.rpc import SCHEDULER_METHODS, SCHEDULER_SERVICE, add_service

        self.server = grpc.server(ThreadPoolExecutor(max_workers=8))
        add_service(self.server, SCHEDULER_SERVICE, {m: SCHEDULER_METHODS[m] for m in FLEET_METHODS}, self)
        self.port = self.server.add_insecure_port("127.0.0.1:0")
        self.server.start()
        return self.port

    def stop(self) -> None:
        if self.server is not None:
            self.server.stop(grace=None).wait(timeout=10)

    # -- the four methods -----------------------------------------------------
    def RegisterExecutor(self, request, context):
        from ballista_tpu_torch.proto import pb

        with self.cond:
            self.registered[request.metadata.id] = request.metadata
        return pb.RegisterExecutorResult(success=True)

    def HeartBeatFromExecutor(self, request, context):
        from ballista_tpu_torch.proto import pb

        with self.cond:
            self.heartbeats[request.executor_id] += 1
            known = request.executor_id in self.registered or request.executor_id in self.executors
        return pb.HeartBeatResult(reregister=not known)

    def UpdateTaskStatus(self, request, context):
        from ballista_tpu_torch.proto import pb

        self._statuses(request.executor_id, request.task_status)
        return pb.UpdateTaskStatusResult(success=True)

    def PollWork(self, request, context):
        from ballista_tpu_torch.proto import pb

        meta = request.metadata
        with self.cond:
            self.executors[meta.id] = meta
            self.polls[meta.id] += 1
        self._statuses(meta.id, request.task_status)
        out = pb.PollWorkResult()
        if not request.can_accept_task:
            return out
        grants = []
        with self.cond:
            budget = max(1, request.free_slots)
            for td in list(self.pending):
                if len(grants) >= budget:
                    break
                t = td.task_id
                key = (t.job_id, t.stage_id, meta.id)
                share = -(-self.stage_tasks[(t.job_id, t.stage_id)] // len(self.executors))
                if self.taken.get(key, 0) < share:
                    self.taken[key] = self.taken.get(key, 0) + 1
                    self.pending.remove(td)
                    grants.append(td)
        if grants:
            out.tasks.extend(grants)
            out.task.CopyFrom(grants[0])
        return out

    def _statuses(self, executor_id: str, statuses) -> None:
        with self.cond:
            for st in statuses:
                t = st.task_id
                if st.WhichOneof("status") == "completed":
                    self.done[(t.job_id, t.stage_id, t.partition_id)] = (executor_id, st.completed)
                else:
                    self.failed.append(((t.job_id, t.stage_id, t.partition_id), st.failed.error))
            self.cond.notify_all()

    # -- one job --------------------------------------------------------------
    def run_job(self, ctx, sql: str, job_id: str, query_class: str, timeout_s: float = 600.0):
        """Run one query on the fleet: returns the terminal stage's output
        (fetched over Flight) as one table, the completed tasks
        ``(stage, executor id, CompletedTask)``, the stages, and the Arrow
        bytes of the batches in the files that later stages read."""
        import pyarrow as pa

        from ballista_tpu_torch.client.flight import fetch_partition
        from ballista_tpu_torch.columnar.arrow_interop import schema_to_arrow
        from ballista_tpu_torch.config import (
            BALLISTA_INTERNAL_QUERY_CLASS,
            BALLISTA_INTERNAL_TASK_ATTEMPT,
            BallistaConfig,
        )
        from ballista_tpu_torch.distributed_plan import DistributedPlanner, remove_unresolved_shuffles
        from ballista_tpu_torch.exec.planner import PhysicalPlanner
        from ballista_tpu_torch.plan.optimizer import optimize
        from ballista_tpu_torch.proto import pb
        from ballista_tpu_torch.scheduler_types import PartitionLocation, PartitionStats
        from ballista_tpu_torch.serde import BallistaCodec

        cfg = BallistaConfig(FLEET_SETTINGS)
        plan = PhysicalPlanner(ctx, FLEET_K, config=cfg, distributed=True).plan(optimize(ctx.sql_to_logical(sql)))
        stages = DistributedPlanner().plan_query_stages(job_id, plan)
        codec = BallistaCodec(provider=ctx)
        props = [pb.KeyValuePair(key=k, value=v) for k, v in FLEET_SETTINGS.items()] + [
            pb.KeyValuePair(key=BALLISTA_INTERNAL_TASK_ATTEMPT, value="0"),
            pb.KeyValuePair(key=BALLISTA_INTERNAL_QUERY_CLASS, value=query_class),
        ]
        locations: dict = {}
        completed = []
        read_paths = []
        for stage in stages:
            wire = codec.physical_to_proto(remove_unresolved_shuffles(stage.plan, locations)).SerializeToString()
            n = stage.input_partition_count
            keys = [(job_id, stage.stage_id, p) for p in range(n)]
            with self.cond:
                self.stage_tasks[(job_id, stage.stage_id)] = n
                self.pending.extend(
                    pb.TaskDefinition(
                        task_id=pb.PartitionId(job_id=job_id, stage_id=stage.stage_id, partition_id=p),
                        plan=wire, props=props, session_id="fleet",
                    )
                    for p in range(n)
                )
                ok = self.cond.wait_for(lambda: self.failed or all(k in self.done for k in keys), timeout_s)
                failed, results = list(self.failed), [self.done.get(k) for k in keys]
            check(ok and not failed, f"{job_id} stage {stage.stage_id}: {failed or 'timed out'}")
            parts = [[] for _ in range(stage.output_partition_count)]
            for p, (executor_id, task) in enumerate(results):
                completed.append((stage.stage_id, executor_id, task))
                meta = self.executors[executor_id]
                for m in task.partitions:
                    parts[m.partition_id].append(PartitionLocation(
                        job_id, stage.stage_id, m.partition_id, executor_id, meta.host, meta.port, m.path,
                        PartitionStats(m.num_rows, m.num_batches, m.num_bytes), map_partition=p,
                    ))
            locations[stage.stage_id] = parts
            if stage is not stages[-1]:
                read_paths += [loc.path for part in parts for loc in part]
        tables = [fetch_partition(loc) for part in locations[stages[-1].stage_id] for loc in part]
        result = pa.concat_tables(tables) if tables else schema_to_arrow(plan.schema()).empty_table()
        return result, completed, stages, sum(arrow_bytes(p) for p in read_paths)


def arrow_bytes(path: str) -> int:
    """The Arrow bytes of the record batches of one shuffle file."""
    import pyarrow as pa
    import pyarrow.ipc as paipc

    with pa.memory_map(path) as src:
        r = paipc.open_file(src)
        return sum(r.get_batch(i).nbytes for i in range(r.num_record_batches))


class RetryCounter:
    """While active, the executors' task attempts count their capacity
    retries and speculation misses here (a ``stats`` dict per task,
    summed under a lock into ``counts``): a retried task reads its inputs
    again."""

    def __enter__(self) -> "RetryCounter":
        import collections
        import threading

        from ballista_tpu_torch.executor import executor as executor_mod

        self.lock = threading.Lock()
        self.counts: collections.Counter = collections.Counter()
        self._mod, self._real = executor_mod, executor_mod.run_with_capacity_retry

        def counted(*a, **kw):
            stats: dict = {}
            try:
                return self._real(*a, stats=stats, **kw)
            finally:
                with self.lock:
                    self.counts.update(stats)

        executor_mod.run_with_capacity_retry = counted
        return self

    def __exit__(self, *exc) -> None:
        self._mod.run_with_capacity_retry = self._real


def process_executor(sched_port: int, pkg_root: pathlib.Path):
    """``python -m ballista_tpu_torch.executor --device cuda`` against the
    stand-in, push-staged (it registers at start and heartbeats)."""
    import tempfile

    work = tempfile.mkdtemp(prefix="ballista_fleet_proc-")
    proc = subprocess.Popen(
        [sys.executable, "-m", "ballista_tpu_torch.executor", "--device", "cuda",
         "--bind-host", "127.0.0.1", "--external-host", "127.0.0.1", "--bind-port", "0",
         "--bind-grpc-port", "0", "--scheduler-host", "127.0.0.1", "--scheduler-port", str(sched_port),
         "--task-scheduling-policy", "push-staged", "--concurrent-tasks", "1", "--work-dir", work],
        cwd=pkg_root, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
    )
    return proc, work


def fleet_path(data: dict, oracles: dict, staged: dict, rec: LaunchRecorder, prec: PartitionRecorder,
               pkg_root: pathlib.Path) -> dict:
    """q1, q3, q5, q12 and q18 on two port executors over Flight, one cold
    and one warm run each, held against collect mode and the numpy
    oracles as phase 8; then the executor process's start and stop."""
    import os
    import shutil
    import signal
    import tempfile
    import threading

    import torch

    from ballista_tpu_torch.exec import spill
    from ballista_tpu_torch.exec.context import TorchContext
    from ballista_tpu_torch.executor import cleanup, reader, shuffle
    from ballista_tpu_torch.executor.executor import Executor, PollLoop, new_executor_id
    from ballista_tpu_torch.executor.flight_service import start_flight_server
    from ballista_tpu_torch.ops import onehot_agg, partition

    ctx = TorchContext(device="cuda")
    for name, tab in data.items():
        ctx.register_table(name, tab)
    sqls = {q: (ROOT / "benchmarks" / "queries" / f"{q}.sql").read_text() for q in FLEET_QUERIES}
    sched = StandInScheduler()
    sched_port = sched.start()
    proc, proc_work = process_executor(sched_port, pkg_root)
    proc_out: list = []
    pump = threading.Thread(target=lambda: proc_out.extend(proc.stdout), daemon=True)
    pump.start()
    fleet = []
    out: dict = {}
    collected: dict = {}  # query -> collect mode's result, for phase 10
    launches = plaunches = glaunches = 0
    try:
        for _ in range(2):
            work = tempfile.mkdtemp(prefix="ballista_fleet-")
            ex = Executor(new_executor_id(), work, provider=ctx, device="cuda")
            svc, fport, fthread = start_flight_server("127.0.0.1", 0, work)
            loop = PollLoop(ex, f"127.0.0.1:{sched_port}", "127.0.0.1", fport, task_slots=2)
            loop.start()
            fleet.append((ex, loop, svc, fthread, work))
        ids = {ex.executor_id for ex, *_ in fleet}
        deadline = time.time() + 30
        while set(sched.executors) != ids and time.time() < deadline:
            time.sleep(0.05)
        check(set(sched.executors) == ids, f"fleet: executors polling {sorted(sched.executors)}, started {sorted(ids)}")
        torch.cuda.reset_peak_memory_stats()
        with RetryCounter() as retries:
            for q in FLEET_QUERIES:
                tag = f"{q}-fleet"
                rec.tag = prec.tag = None
                want = ctx.sql(sqls[q]).collect()
                runs = []
                # the first launch at each shape keeps its inputs on the
                # host for the replay: the shapes of a run depend on which
                # tasks retried, so a later capture run could miss some
                rec.tag = prec.tag = tag
                rec.keep = prec.keep = rec.keep_on_host = prec.keep_on_host = True
                # a cold and one warm run (the second warm run was cut for
                # the script's length): the warm run is held bit for bit to
                # the cold one where neither retried
                for i in range(2):
                    # this run starts here
                    onehot_agg.launches = partition.launches = partition.group_launches = 0
                    spill.reset_stats(shuffle.stats)
                    reader.reset_stats()
                    retries.counts.clear()
                    job = f"{q}-fleet-{i}"
                    t = time.perf_counter()
                    res, tasks, stages, written = sched.run_job(ctx, sqls[q], job, q)
                    torch.cuda.synchronize()
                    secs = time.perf_counter() - t
                    launches += onehot_agg.launches
                    plaunches += partition.launches
                    glaunches += partition.group_launches
                    compare_tables(f"{tag} run {i}", res, want)
                    for c in STAGED_EXACT.get(q, ()):
                        check(res.column(c).equals(want.column(c)), f"{tag} run {i}: {c} not bit for bit")
                    if q in oracles:
                        compare(f"{tag} run {i}", res, oracles[q])
                    per_exec = {e: sum(1 for _, x, _ in tasks if x == e) for e in ids}
                    check(min(per_exec.values()) > 0, f"{tag} run {i}: tasks per executor {per_exec}")
                    check(
                        all(task.HasField("cost") and len(task.operator_metrics) for _, _, task in tasks),
                        f"{tag} run {i}: a task reported no cost vector or no operator metrics",
                    )
                    fetched = reader.stats["flight_bytes"]
                    retried = dict(retries.counts)
                    check(
                        fetched == written if not any(retried.values()) else fetched >= written,
                        f"{tag} run {i}: {fetched} bytes fetched over Flight, {written} written "
                        f"(task retries {retried})",
                    )
                    check(
                        shuffle.stats["waits"] == shuffle.stats["batches"] == partition.group_launches > 0,
                        f"{tag} run {i}: {shuffle.stats['waits']} waits, {partition.group_launches} grouped "
                        f"launches for {shuffle.stats['batches']} hash-partitioned batches",
                    )
                    fetch_s = sum(
                        float(kv.value)
                        for _, _, task in tasks for m in task.operator_metrics
                        if m.operator == "ShuffleReaderExec" for kv in m.counters if kv.key == "fetch_time"
                    )
                    for *_, work in fleet:
                        check(cleanup.clean_shuffle_data(work, -1) == [job], f"{tag} run {i}: job dir of {work}")
                        check(not os.listdir(work), f"{tag} run {i}: {work} not empty after the run")
                    runs.append(dict(
                        s=secs, table=res, tasks=per_exec, stages=len(stages), retries=retried,
                        flight_mb=fetched / 2**20, flight_batches=reader.stats["flight_batches"],
                        written_mb=written / 2**20, fetch_s=fetch_s,
                        cost=dict(
                            wall_s=sum(t.cost.wall_seconds for _, _, t in tasks),
                            compile_s=sum(t.cost.compile_seconds for _, _, t in tasks),
                            read_mb=sum(t.cost.shuffle_read_bytes for _, _, t in tasks) / 2**20,
                            write_mb=sum(t.cost.shuffle_write_bytes for _, _, t in tasks) / 2**20,
                        ),
                        launches=onehot_agg.launches, plaunches=partition.launches,
                        glaunches=partition.group_launches,
                    ))
                collected[q] = want
                same = not any(runs[0]["retries"].values()) and not any(runs[1]["retries"].values())
                if same:
                    check(runs[1]["table"].equals(runs[0]["table"]), f"{tag}: warm run differs from the cold run")
                st = staged[f"{q}-stages"]
                out[tag] = dict(
                    warm_equals_cold=True if same else "not checked: a run retried",
                    stages=runs[0]["stages"], rows=want.num_rows,
                    tasks_per_executor=[sorted(r["tasks"].values()) for r in runs],
                    flight_mb=[r["flight_mb"] for r in runs], flight_batches=[r["flight_batches"] for r in runs],
                    fetch_s=[r["fetch_s"] for r in runs], retries=[r["retries"] for r in runs],
                    cold_s=runs[0]["s"], warm_s=[r["s"] for r in runs[1:]],
                    staged_cold_s=st["cold_s"], staged_warm_s=st["warm_s"],
                    collect_cold_s=st["collect_cold_s"], collect_warm_s=st["collect_warm_s"],
                    cost=[r["cost"] for r in runs],
                    onehot_launches=[r["launches"] for r in runs],
                    partition_launches=[r["plaunches"] for r in runs],
                    grouped_launches=[r["glaunches"] for r in runs],
                    partition_shapes=sorted(set(prec.shapes.get(tag, []))),
                    onehot_shapes=sorted(set(rec.shapes.get(tag, []))),
                )
                log(f"{tag}: ok  {json.dumps(out[tag])}")
        rec.tag = prec.tag = None
        rec.keep = prec.keep = rec.keep_on_host = prec.keep_on_host = False
        # collect mode of the cluster's queries the fleet does not run
        for q in CLUSTER_QUERIES:
            if q not in collected:
                collected[q] = ctx.sql((ROOT / "benchmarks" / "queries" / f"{q}.sql").read_text()).collect()
        peak = torch.cuda.max_memory_allocated()
        log(f"fleet: peak device memory {peak} bytes ({peak / 2**30:.3f} GiB)")
        for q in FLEET_QUERIES:
            check(min(out[f"{q}-fleet"]["grouped_launches"]) > 0, f"{q}-fleet: no grouped launch")
        check(min(out["q1-fleet"]["onehot_launches"]) > 0, "q1-fleet did not launch the one-hot kernel")
        for r in (rec, prec):
            for q in FLEET_QUERIES:
                missing = set(r.shapes.get(f"{q}-fleet", [])) - set(r.inputs)
                check(not missing, f"{q}-fleet: no inputs kept for launch shapes {sorted(missing)}")

        # the process entry: registered at its start, heartbeats every 15 s
        deadline = time.time() + 60
        while not sched.heartbeats and time.time() < deadline and proc.poll() is None:
            time.sleep(0.2)
        check(proc.poll() is None, "executor process exited early:\n" + "".join(proc_out[-40:]))
        check(len(sched.registered) == 1 and sum(sched.heartbeats.values()) >= 1,
              f"executor process: registered {list(sched.registered)}, heartbeats {dict(sched.heartbeats)}")
        t = time.perf_counter()
        proc.send_signal(signal.SIGTERM)
        rc = proc.wait(timeout=10)
        stop_s = time.perf_counter() - t
        check(rc == 0, f"executor process exited {rc} on SIGTERM:\n" + "".join(proc_out[-40:]))
        out["process"] = dict(
            registered=list(sched.registered), heartbeats=sum(sched.heartbeats.values()), stop_s=stop_s,
            device_line=next((line.strip() for line in proc_out if "device=cuda" in line), ""),
        )
        log(f"fleet process: ok  {json.dumps(out['process'])}")
    finally:
        rec.tag = prec.tag = None
        rec.keep = prec.keep = rec.keep_on_host = prec.keep_on_host = False
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=30)
        for ex, loop, svc, fthread, work in fleet:
            loop.stop()
            svc.shutdown()
            fthread.join(timeout=10)
            shutil.rmtree(work, ignore_errors=True)
        shutil.rmtree(proc_work, ignore_errors=True)
        sched.stop()
    for *_, work in fleet:
        check(not os.path.exists(work), f"fleet: work directory {work} left behind")
    out["collect"] = collected
    out["launches"] = launches
    out["partition_launches"] = plaunches
    out["grouped_launches"] = glaunches
    out["peak_bytes"] = peak
    return out


# -- phase 10: the port's own cluster (scheduler, standalone, client) --------

CLUSTER_QUERIES = STAGED_QUERIES + ("q18",)
# every session of phase 10 at K = 4; all else at its default
CLUSTER_SETTINGS = {"ballista.shuffle.partitions": str(STAGED_K)}
# (c): the TPC-H queries (a) does not run
CLUSTER_OTHER = tuple(f"q{i}" for i in range(1, 23) if f"q{i}" not in CLUSTER_QUERIES)
# (d)'s liveness knobs: the executor timeout and the expiry sweep of the
# reference's chaos tests, and an eager wait of 5 s (by default 60 s): eager
# consumers may hold every slot of the surviving executor while the
# producers they wait for are requeued, and only the eager-wait deadline
# frees one
LOSS_SETTINGS = {**CLUSTER_SETTINGS, "ballista.tpu.eager_wait_s": "5"}


def job_readers(job) -> dict:
    """The job's shuffle readers' counters, summed over the operator
    metrics its tasks shipped home."""
    out: dict = {}
    for records in job.op_metrics.values():
        for r in records:
            if r["operator"] == "ShuffleReaderExec":
                for k, v in r["counters"].items():
                    out[k] = out.get(k, 0) + v
    return out


def hist_summary(vec) -> dict:
    """One histogram family of the scheduler by label: count, sum, p50, p90."""
    out = {}
    for labels, h in vec.children():
        _, total, count = h.snapshot()
        out["/".join(labels) or "-"] = dict(
            count=count, sum_s=total, p50_s=h.quantile(0.5), p90_s=h.quantile(0.9)
        )
    return out


def cluster_path(data: dict, oracles: dict, collected: dict, earlier: dict, fleet: dict,
                 rec: LaunchRecorder, prec: PartitionRecorder, pkg_root: pathlib.Path) -> dict:
    """(a)-(e) of phase 10: the port's scheduler, cluster and client.
    ``collected``: phase 9's collect-mode results of the five queries;
    ``earlier``: query -> (SQL, the card's collect-mode result) of phases
    4-6 for the other seventeen. Every launch of the phase keeps the inputs
    of the first launch at its shape, on the host, for the replay."""
    import torch

    from ballista_tpu_torch.client.context import BallistaContext
    from ballista_tpu_torch.config import BallistaConfig, TaskSchedulingPolicy
    from ballista_tpu_torch.exec import spill
    from ballista_tpu_torch.executor import push, reader, shuffle
    from ballista_tpu_torch.ops import onehot_agg, partition

    sqls = {q: (ROOT / "benchmarks" / "queries" / f"{q}.sql").read_text() for q in CLUSTER_QUERIES}
    out: dict = {}
    launches = plaunches = glaunches = 0

    def cluster(settings: dict, **kw) -> BallistaContext:
        ctx = BallistaContext.standalone(
            BallistaConfig(settings), device="cuda", n_executors=2, concurrent_tasks=2, **kw
        )
        for name, tab in data.items():
            ctx.register_table(name, tab)
        return ctx

    def one_run(ctx, sql: str) -> dict:
        """One query through the cluster, its counts set to 0 just before
        and read just after."""
        nonlocal launches, plaunches, glaunches
        sched = ctx._standalone_cluster.scheduler
        onehot_agg.launches = partition.launches = partition.group_launches = 0
        spill.reset_stats(shuffle.stats)
        reader.reset_stats()
        retries.counts.clear()
        pushed0 = push.REGISTRY.total_pushed
        jobs0 = set(sched.jobs)
        t = time.perf_counter()
        res = ctx.sql(sql).collect()
        torch.cuda.synchronize()
        secs = time.perf_counter() - t
        launches += onehot_agg.launches
        plaunches += partition.launches
        glaunches += partition.group_launches
        (job_id,) = set(sched.jobs) - jobs0
        job = sched.jobs[job_id]
        check(job.status == "completed", f"job {job_id}: {job.status} {job.error}")
        rd = job_readers(job)
        per_exec: dict = {}
        for st in job.stage_stats or []:
            for task in st["tasks"]:
                per_exec[task["executor_id"]] = per_exec.get(task["executor_id"], 0) + 1
        return dict(
            s=secs, table=res, stages=len(job.stages), tasks=per_exec,
            launches=onehot_agg.launches, plaunches=partition.launches,
            glaunches=partition.group_launches, write=dict(shuffle.stats),
            flight_mb=reader.stats["flight_bytes"] / 2**20, fetch_s=rd.get("fetch_time", 0.0),
            eager_polls=int(rd.get("eager_polls", 0)), eager_waits=int(rd.get("eager_waits", 0)),
            pushed_mb=(push.REGISTRY.total_pushed - pushed0) / 2**20,
            task_retries=job.total_retries, recomputes=job.total_recomputes,
            capacity_retries=dict(retries.counts),
        )

    def held(tag: str, q: str, r: dict) -> None:
        """(a) and (b): against collect mode and the oracles as phase 8,
        every hash-partitioned batch grouped with one wait, and reads that
        were eager-fed or pushed."""
        res, want = r["table"], collected[q]
        compare_tables(tag, res, want)
        for c in STAGED_EXACT.get(q, ()):
            check(res.column(c).equals(want.column(c)), f"{tag}: {c} not bit for bit")
        if q in oracles:
            compare(tag, res, oracles[q])
        check(
            r["write"]["waits"] == r["write"]["batches"] == r["glaunches"] > 0,
            f"{tag}: {r['write']['waits']} waits, {r['glaunches']} grouped launches for "
            f"{r['write']['batches']} hash-partitioned batches",
        )
        check(r["eager_polls"] > 0 or r["pushed_mb"] > 0, f"{tag}: no eager-fed or pushed read")

    def summary(q: str, runs: list) -> dict:
        fl = fleet.get(f"{q}-fleet", dict.fromkeys(("cold_s", "warm_s", "collect_cold_s", "collect_warm_s")))
        return dict(
            stages=runs[0]["stages"], tasks_per_executor=[sorted(r["tasks"].values()) for r in runs],
            flight_mb=[r["flight_mb"] for r in runs], fetch_s=[r["fetch_s"] for r in runs],
            eager_polls=[r["eager_polls"] for r in runs], eager_waits=[r["eager_waits"] for r in runs],
            pushed_mb=[r["pushed_mb"] for r in runs],
            cold_s=runs[0]["s"], warm_s=[r["s"] for r in runs[1:]],
            fleet_cold_s=fl["cold_s"], fleet_warm_s=fl["warm_s"],
            collect_cold_s=fl["collect_cold_s"], collect_warm_s=fl["collect_warm_s"],
            task_retries=[r["task_retries"] for r in runs], recomputes=[r["recomputes"] for r in runs],
            capacity_retries=[r["capacity_retries"] for r in runs],
            onehot_launches=[r["launches"] for r in runs],
            partition_launches=[r["plaunches"] for r in runs],
            grouped_launches=[r["glaunches"] for r in runs],
        )

    # (e) runs beside (a)-(d) on a thread of its own: its processes take
    # some 10 s to start and the executor heartbeats every 15 s
    import concurrent.futures

    pool = concurrent.futures.ThreadPoolExecutor(1)
    processes = pool.submit(process_cluster, pkg_root)
    torch.cuda.reset_peak_memory_stats()
    rec.keep = prec.keep = rec.keep_on_host = prec.keep_on_host = True
    try:
        with RetryCounter() as retries:
            # (a) default settings, pull-staged, then (c) on the same
            # cluster; (b) push-staged
            for part, policy, n_runs in (
                ("cluster", TaskSchedulingPolicy.PULL_STAGED, 3),
                # one run: the phase's time went over two minutes with a
                # warm one (its aim), and (a) holds the warm runs
                ("cluster-push", TaskSchedulingPolicy.PUSH_STAGED, 1),
            ):
                t0 = time.perf_counter()
                ctx = cluster(CLUSTER_SETTINGS, policy=policy)
                try:
                    # q18 runs push-staged no more: its 10-13 s a run made
                    # room for phase 16 (the other four cover the path)
                    for q in CLUSTER_QUERIES if part == "cluster" else STAGED_QUERIES:
                        tag = f"{q}-{part}"
                        rec.tag = prec.tag = tag
                        runs = []
                        # q18 takes 11-17 s a run: its cold run only (its
                        # warm run was cut to make room for phase 17)
                        for i in range(1 if q == "q18" else n_runs):
                            runs.append(one_run(ctx, sqls[q]))
                            held(f"{tag} run {i}", q, runs[-1])
                        if len(runs) == 3:
                            check(runs[1]["table"].equals(runs[2]["table"]), f"{tag}: two warm runs differ")
                        out[tag] = summary(q, runs)
                        log(f"{tag}: ok  {json.dumps(out[tag])}")
                    check(min(out[f"q1-{part}"]["onehot_launches"]) > 0, f"q1-{part}: no one-hot launch")
                    for q in CLUSTER_OTHER if part == "cluster" else ():
                        sql, want = earlier[q]
                        rec.tag = prec.tag = f"{q}-cluster"
                        r = one_run(ctx, sql)
                        key = [(c, "ascending") for c in want.column_names]
                        compare_tables(f"{q}-cluster", r["table"].sort_by(key), want.sort_by(key))
                        out[f"{q}-cluster"] = dict(
                            rows=want.num_rows, stages=r["stages"],
                            tasks_per_executor=sorted(r["tasks"].values()), s=r["s"],
                            eager_polls=r["eager_polls"], pushed_mb=r["pushed_mb"],
                            task_retries=r["task_retries"], capacity_retries=r["capacity_retries"],
                            onehot_launches=r["launches"], partition_launches=r["plaunches"],
                            grouped_launches=r["glaunches"],
                        )
                        log(f"{q}-cluster: ok  {json.dumps(out[f'{q}-cluster'])}")
                    sched = ctx._standalone_cluster.scheduler
                    out[f"{part}_hists"] = dict(
                        queue_wait=hist_summary(sched._h_queue_wait),
                        job_latency=hist_summary(sched._h_job_latency),
                    )
                    log(f"{part} scheduler histograms: {json.dumps(out[f'{part}_hists'])}")
                finally:
                    rec.tag = prec.tag = None
                    ctx.close()
                out[f"{part}_s"] = time.perf_counter() - t0

            # (d) executor loss between q3's stages
            t0 = time.perf_counter()
            ctx = cluster(LOSS_SETTINGS, executor_timeout_s=5.0, expiry_check_interval_s=1.0)
            try:
                cl = ctx._standalone_cluster
                sched = cl.scheduler
                killed: list = []
                expired: list = []
                finished, sweep = sched._on_stage_finished, sched.check_expired_executors

                def on_stage_finished(job_id, stage_id):
                    if not killed:
                        killed.append(kill_last_writer(cl, job_id, stage_id))
                    finished(job_id, stage_id)

                def check_expired():
                    ids = sweep()
                    expired.extend(ids)
                    return ids

                sched._on_stage_finished = on_stage_finished
                sched.check_expired_executors = check_expired
                rec.tag = prec.tag = "q3-loss"
                r = one_run(ctx, sqls["q3"])
                rec.tag = prec.tag = None
                deadline = time.time() + 15
                while not expired and time.time() < deadline:
                    time.sleep(0.1)
                check(bool(killed) and expired == killed, f"loss: killed {killed}, scheduler reported {expired}")
                compare_tables("q3-loss", r["table"], collected["q3"])
                if "q3" in oracles:
                    compare("q3-loss", r["table"], oracles["q3"])
                check(r["task_retries"] + r["recomputes"] > 0, "loss: nothing of the killed executor was recomputed")
                out["q3-loss"] = dict(
                    s=r["s"], killed=killed, reported=expired, task_retries=r["task_retries"],
                    recomputes=r["recomputes"], tasks_per_executor=r["tasks"],
                    eager_polls=r["eager_polls"], eager_waits=r["eager_waits"],
                    onehot_launches=r["launches"], grouped_launches=r["glaunches"],
                )
                log(f"q3-loss: ok  {json.dumps(out['q3-loss'])}")
            finally:
                rec.tag = prec.tag = None
                ctx.close()
            out["loss_s"] = time.perf_counter() - t0
    finally:
        rec.tag = prec.tag = None
        rec.keep = prec.keep = rec.keep_on_host = prec.keep_on_host = False
    peak = torch.cuda.max_memory_allocated()
    log(f"cluster: peak device memory {peak} bytes ({peak / 2**30:.3f} GiB)")
    for r in (rec, prec):
        for tag in r.shapes:
            if tag.endswith(("-cluster", "-cluster-push", "-loss")):
                missing = set(r.shapes[tag]) - set(r.inputs)
                check(not missing, f"{tag}: no inputs kept for launch shapes {sorted(missing)}")

    # (e) the scheduler and executor processes, started with the phase
    t0 = time.perf_counter()
    out["processes"] = processes.result(timeout=300)
    pool.shutdown()
    out["processes_wait_s"] = time.perf_counter() - t0
    out["launches"] = launches
    out["partition_launches"] = plaunches
    out["grouped_launches"] = glaunches
    out["peak_bytes"] = peak
    return out


# -- phase 11: file tables on the card -----------------------------------------

# rows in a Parquet row group: at SF=1 lineitem has 6 groups, orders 2
FILE_GROUP_ROWS = 1 << 20
# the sort path's money sums, bit for bit against the memory tables' runs
FILE_EXACT = {**MONEY_SUMS, **STAGED_EXACT}
STREAM_QUERIES = ("q1", "q6", "q18")
# (c)'s ballista.tpu.scan_stream_mb: a partition's three lineitem row groups
# hold 16 (q18) to 38 (q1) MB of the projected columns as the file encodes
# them, so a threshold of 64 MB would stream none of the three
STREAM_MB = "8"
TEXT_QUERIES = ("q5", "q7")
TEXT_TABLES = ("nation", "region", "supplier")
SCAN_COUNTERS = ("row_groups_pruned", "stream_slices", "prefetch_hits", "prefetch_misses")


def plan_read_s(plan) -> float:
    """The file scans' summed ``read_time`` in one run's plan."""
    total = plan.metrics.timers.get("read_time", 0.0)
    return total + sum(plan_read_s(c) for c in plan.children())


def sorted_rows(t):
    return t.sort_by([(c, "ascending") for c in t.column_names])


def held_as(tag: str, q: str, got, want, exact: bool) -> None:
    """Rows sorted (file scans partition by row groups, so ties may come in
    another order): keys and counts exactly, floats within rtol 1e-9, and
    with ``exact`` the sort path's money sums bit for bit."""
    g, w = sorted_rows(got), sorted_rows(want)
    compare_tables(tag, g, w)
    for c in FILE_EXACT.get(q, ()) if exact else ():
        check(g.column(c).equals(w.column(c)), f"{tag}: {c} not bit for bit")


def files_path(data: dict, oracles: dict, earlier: dict, tmp: pathlib.Path, rec: LaunchRecorder,
               prec: PartitionRecorder) -> dict:
    """(a)-(f) of phase 11: the TPC-H tables of phase 5 as Parquet files
    (row groups of 2^20 rows), CSV and Avro files in the directory ``tmp``
    (phase 12 reads the Parquet files too; the caller deletes it),
    registered by ``CREATE EXTERNAL TABLE``. ``out["results"]`` holds (a)'s
    third run of each query.
    ``earlier``: query -> (SQL, the card's memory-table result) of phases
    4-6. Every launch keeps the inputs of the first launch at its shape,
    on the host, for the replay."""
    import gc

    import pyarrow.csv as pacsv
    import pyarrow.parquet as papq
    import torch

    from ballista_tpu_torch.avro import write_avro
    from ballista_tpu_torch.client.context import BallistaContext
    from ballista_tpu_torch.columnar.arrow_interop import schema_from_arrow
    from ballista_tpu_torch.config import BallistaConfig
    from ballista_tpu_torch.exec.base import plan_counters
    from ballista_tpu_torch.exec.context import TorchContext
    from ballista_tpu_torch.exec.scan import ParquetScanExec
    from ballista_tpu_torch.ops import onehot_agg, partition
    from ballista_tpu_torch.proto import pb

    out: dict = {}
    launches = plaunches = glaunches = 0

    def ddl(name: str, fmt: str = "parquet", path=None) -> str:
        stored = {"parquet": "PARQUET", "csv": "CSV WITH HEADER ROW", "avro": "AVRO"}[fmt]
        return f"CREATE EXTERNAL TABLE {name} STORED AS {stored} LOCATION '{path or tmp / f'{name}.{fmt}'}'"

    def context(settings: dict | None = None, text: str | None = None, names=None) -> TorchContext:
        ctx = TorchContext(BallistaConfig(settings or {}), device="cuda")
        for name in names or data:
            ctx.sql(ddl(name, text if text and name in TEXT_TABLES else "parquet"))
        return ctx

    def release(*ctxs) -> None:
        for c in ctxs:
            c.tables.clear()
            c._physical_cache.clear()
        gc.collect()
        torch.cuda.empty_cache()

    def one(ctx, sql: str) -> dict:
        """One collect run, the kernels' counts set to 0 just before it and
        read just after."""
        nonlocal launches, plaunches, glaunches
        onehot_agg.launches = partition.launches = partition.group_launches = 0
        t = time.perf_counter()
        df = ctx.sql(sql)
        res, plan = df.collect_with_plan()
        torch.cuda.synchronize()
        secs = time.perf_counter() - t
        launches += onehot_agg.launches
        plaunches += partition.launches
        glaunches += partition.group_launches
        return dict(
            s=secs, table=res, read_s=plan_read_s(plan), launches=onehot_agg.launches,
            plaunches=partition.launches, retries=df.stats.get("capacity_retries", 0)
            + df.stats.get("speculation_misses", 0), **plan_counters(plan, SCAN_COUNTERS),
        )

    rec.keep = prec.keep = rec.keep_on_host = prec.keep_on_host = True
    try:
        t0 = time.perf_counter()
        for name, tab in data.items():
            papq.write_table(tab, tmp / f"{name}.parquet", row_group_size=FILE_GROUP_ROWS)
        groups = {n: papq.ParquetFile(tmp / f"{n}.parquet").num_row_groups for n in ("lineitem", "orders")}
        out["write_parquet_s"] = time.perf_counter() - t0
        log(f"files: Parquet written in {out['write_parquet_s']:.2f}s, row groups {groups}")

        # (a) all 22 queries over Parquet tables created by DDL
        t0 = time.perf_counter()
        torch.cuda.reset_peak_memory_stats()
        ctx = context()
        results: dict = {}
        for i in range(1, 23):
            q = f"q{i}"
            sql, want = earlier[q]
            tag = f"{q}-files"
            rec.tag = prec.tag = tag
            runs = [one(ctx, sql) for _ in range(3)]
            rec.tag = prec.tag = None
            for j, r in enumerate(runs):
                held_as(f"{tag} run {j}", q, r["table"], want, exact=j == 2)
            check(runs[1]["table"].equals(runs[2]["table"]), f"{tag}: two warm runs differ")
            check(all(r["retries"] == 0 for r in runs[1:]), f"{tag}: a warm run retried")
            results[q] = runs[2]["table"]
            out[tag] = dict(
                rows=want.num_rows, cold_s=runs[0]["s"], warm_s=[r["s"] for r in runs[1:]],
                read_s=[r["read_s"] for r in runs], row_groups_pruned=runs[0]["row_groups_pruned"],
                capacity_retries=[r["retries"] for r in runs], onehot_launches=[r["launches"] for r in runs],
                partition_launches=[r["plaunches"] for r in runs],
            )
            log(f"{tag}: ok  {json.dumps(out[tag])}")
        check(min(out["q1-files"]["onehot_launches"]) > 0, "q1 over Parquet did not launch the one-hot kernel")
        out["results"] = results
        out["collect_peak_bytes"] = torch.cuda.max_memory_allocated()

        # (f) the statements, on (a)'s context
        q1 = earlier["q1"][0]
        names = ctx.sql("SHOW TABLES").collect().column("table_name").to_pylist()
        check(names == sorted(data), f"SHOW TABLES: {names}")
        cols = ctx.sql("SHOW COLUMNS FROM lineitem").collect()
        li = schema_from_arrow(papq.read_schema(tmp / "lineitem.parquet"))
        check(
            cols.to_pydict() == {
                "column_name": [f.name for f in li], "data_type": [f.dtype.value for f in li],
                "nullable": [f.nullable for f in li],
            },
            f"SHOW COLUMNS FROM lineitem: {cols.to_pydict()}",
        )
        verbose = ctx.sql(f"EXPLAIN VERBOSE {q1}").collect().to_pydict()
        check(verbose["plan_type"] == ["logical_plan", "optimized_plan", "physical_plan"], f"EXPLAIN VERBOSE: {verbose['plan_type']}")
        check(
            verbose["plan"][2] == ctx.create_physical_plan(ctx.sql_to_logical(q1)).display()
            and "ParquetScanExec" in verbose["plan"][2],
            f"EXPLAIN VERBOSE's physical plan: {verbose['plan'][2]}",
        )
        verify = ctx.sql(f"EXPLAIN VERIFY {q1}").collect().to_pydict()
        check(
            verify["plan_type"] == ["logical_plan", "optimized_plan", "verification"]
            and "FAILED" not in verify["plan"][2],
            f"EXPLAIN VERIFY: {verify}",
        )
        rec.tag = prec.tag = "q1-analyze"
        analyzed = ctx.sql(f"EXPLAIN ANALYZE {q1}").collect().to_pydict()
        rec.tag = prec.tag = None
        lines = analyzed["plan"][0].split("\n")
        rows = {ln.strip().split("  [")[0].split(":")[0]: ln for ln in lines}
        # q1's filter: l_shipdate <= date '1998-12-01' - interval '90' day
        last_day = _day(1998, 9, 2)
        shipped = int((data["lineitem"].column("l_shipdate").cast("int32").to_numpy() <= last_day).sum())
        check(
            analyzed["plan_type"] == ["physical_plan (analyzed)", "analyze_summary", "aqe"]
            and f"rows={results['q1'].num_rows}," in lines[0]
            and f"rows={shipped}," in rows.get("FilterExec", "")
            and "ParquetScanExec" in rows and "elapsed=" in rows["ParquetScanExec"],
            f"EXPLAIN ANALYZE: {analyzed}",
        )
        check(ctx.sql("DROP TABLE region").collect().to_pydict() == {"result": ["ok"]}, "DROP TABLE")
        check("region" not in ctx.sql("SHOW TABLES").collect().column("table_name").to_pylist(), "DROP TABLE kept region")
        out["statements"] = dict(
            show_tables=names, analyzed=analyzed["plan"][0], summary=analyzed["plan"][1],
        )
        log(f"statements: ok  EXPLAIN ANALYZE of q1:\n{analyzed['plan'][0]}\n{analyzed['plan'][1]}")
        release(ctx)
        out["collect_s"] = time.perf_counter() - t0

        # (b) pruning: lineitem sorted by l_shipdate
        t0 = time.perf_counter()
        sorted_path = tmp / "lineitem_sorted.parquet"
        papq.write_table(data["lineitem"].sort_by("l_shipdate"), sorted_path, row_group_size=FILE_GROUP_ROWS)
        for pruning in ("true", "false"):
            c = TorchContext(BallistaConfig({"ballista.parquet.pruning": pruning}), device="cuda")
            c.sql(ddl("lineitem", path=sorted_path))
            for q in ("q6", "q1"):
                tag = f"{q}-pruned-{pruning}"
                rec.tag = prec.tag = tag
                r = one(c, earlier[q][0])
                rec.tag = prec.tag = None
                held_as(tag, q, r["table"], results[q], exact=False)
                out[tag] = dict(s=r["s"], read_s=r["read_s"], row_groups_pruned=r["row_groups_pruned"])
                log(f"{tag}: ok  {json.dumps(out[tag])}")
            release(c)
        check(out["q6-pruned-true"]["row_groups_pruned"] >= 1, "q6 over the sorted lineitem pruned no row group")
        check(out["q6-pruned-false"]["row_groups_pruned"] == 0, "q6 pruned with ballista.parquet.pruning=false")
        out["pruning_s"] = time.perf_counter() - t0

        # (c) streaming: every row group its own slice
        t0 = time.perf_counter()
        old_slice = ParquetScanExec.STREAM_SLICE_BYTES
        ParquetScanExec.STREAM_SLICE_BYTES = 1
        try:
            streamed: dict = {}
            for depth in (0, 1):
                torch.cuda.reset_peak_memory_stats()
                c = context({"ballista.tpu.scan_stream_mb": STREAM_MB, "ballista.tpu.prefetch_depth": str(depth)})
                for q in STREAM_QUERIES:
                    tag = f"{q}-stream{depth}"
                    rec.tag = prec.tag = tag
                    r = one(c, earlier[q][0])
                    rec.tag = prec.tag = None
                    held_as(tag, q, r["table"], results[q], exact=False)
                    check(r["stream_slices"] >= 3, f"{tag}: {r['stream_slices']} stream slices")
                    # a partition of one slice has nothing to prefetch
                    fetched = r["prefetch_hits"] + r["prefetch_misses"]
                    check(
                        0 < fetched <= r["stream_slices"] if depth else fetched == 0,
                        f"{tag}: {fetched} prefetches of {r['stream_slices']} slices",
                    )
                    streamed[tag] = r["table"]
                    out[tag] = dict(
                        s=r["s"], read_s=r["read_s"], stream_slices=r["stream_slices"],
                        prefetch_hits=r["prefetch_hits"], prefetch_misses=r["prefetch_misses"],
                        capacity_retries=r["retries"],
                    )
                    log(f"{tag}: ok  {json.dumps(out[tag])}")
                out[f"stream{depth}_peak_bytes"] = torch.cuda.max_memory_allocated()
                release(c)
        finally:
            ParquetScanExec.STREAM_SLICE_BYTES = old_slice
        for q in STREAM_QUERIES:
            check(streamed[f"{q}-stream0"].equals(streamed[f"{q}-stream1"]), f"{q}: depths 0 and 1 differ")
        out["stream_s"] = time.perf_counter() - t0

        # (d) nation, region and supplier as CSV and as Avro files
        t0 = time.perf_counter()
        for name in TEXT_TABLES:
            pacsv.write_csv(data[name], tmp / f"{name}.csv")
            write_avro(str(tmp / f"{name}.avro"), data[name])
        for fmt in ("csv", "avro"):
            c = context(text=fmt)
            for q in TEXT_QUERIES:
                tag = f"{q}-{fmt}"
                rec.tag = prec.tag = tag
                runs = [one(c, earlier[q][0]) for _ in range(2)]
                rec.tag = prec.tag = None
                for j, r in enumerate(runs):
                    held_as(f"{tag} run {j}", q, r["table"], results[q], exact=j == 1)
                out[tag] = dict(cold_s=runs[0]["s"], warm_s=runs[1]["s"], read_s=[r["read_s"] for r in runs])
                log(f"{tag}: ok  {json.dumps(out[tag])}")
            release(c)
        out["text_s"] = time.perf_counter() - t0

        # (e) the port's cluster, the tables created by DDL through the client
        t0 = time.perf_counter()
        torch.cuda.reset_peak_memory_stats()
        cl = BallistaContext.standalone(
            BallistaConfig(CLUSTER_SETTINGS), device="cuda", n_executors=2, concurrent_tasks=2
        )
        try:
            for name in data:
                check(cl.sql(ddl(name)).collect().to_pydict() == {"result": ["ok"]}, f"DDL of {name}")
            sched = cl._standalone_cluster.scheduler
            # q18 runs on the cluster in phase 10 (a), cold and once warm
            for q in STAGED_QUERIES:
                tag = f"{q}-files-cluster"
                runs = []
                rec.tag = prec.tag = tag
                # a cold and one warm run (the second warm run was cut for
                # the script's length): the warm run is held bit for bit to
                # the cold one where neither retried
                for j in range(2):
                    onehot_agg.launches = partition.launches = partition.group_launches = 0
                    jobs0 = set(sched.jobs)
                    t = time.perf_counter()
                    res = cl.sql(earlier[q][0]).collect()
                    torch.cuda.synchronize()
                    secs = time.perf_counter() - t
                    launches += onehot_agg.launches
                    plaunches += partition.launches
                    glaunches += partition.group_launches
                    (job_id,) = set(sched.jobs) - jobs0
                    job = sched.jobs[job_id]
                    check(job.status == "completed", f"{tag}: job {job.status} {job.error}")
                    held_as(f"{tag} run {j}", q, res, results[q], exact=True)
                    if q in oracles:
                        compare(f"{tag} run {j}", res, oracles[q])
                    check(partition.group_launches > 0, f"{tag} run {j}: no grouped launch")
                    runs.append(dict(
                        s=secs, table=res, stages=len(job.stages), launches=onehot_agg.launches,
                        glaunches=partition.group_launches, task_retries=job.total_retries,
                    ))
                rec.tag = prec.tag = None
                same = runs[0]["task_retries"] == runs[1]["task_retries"] == 0
                if same:
                    check(runs[1]["table"].equals(runs[0]["table"]), f"{tag}: warm run differs from the cold run")
                out[tag] = dict(
                    warm_equals_cold=True if same else "not checked: a task retried",
                    stages=runs[0]["stages"], cold_s=runs[0]["s"], warm_s=[r["s"] for r in runs[1:]],
                    onehot_launches=[r["launches"] for r in runs], grouped_launches=[r["glaunches"] for r in runs],
                    task_retries=[r["task_retries"] for r in runs],
                )
                log(f"{tag}: ok  {json.dumps(out[tag])}")
            meta = cl._stub.GetFileMetadata(
                pb.GetFileMetadataParams(path=str(tmp / "lineitem.parquet"), file_type="parquet")
            )
            got = [f.name for f in meta.schema.fields]
            check(got == data["lineitem"].column_names, f"GetFileMetadata: {got}")
            out["get_file_metadata"] = got
        finally:
            rec.tag = prec.tag = None
            cl.close()
        out["cluster_peak_bytes"] = torch.cuda.max_memory_allocated()
        out["cluster_s"] = time.perf_counter() - t0
    finally:
        rec.tag = prec.tag = None
        rec.keep = prec.keep = rec.keep_on_host = prec.keep_on_host = False
    for r in (rec, prec):
        for tag in r.shapes:
            if tag.endswith(("-files", "-files-cluster", "-csv", "-avro", "-analyze")) or "-stream" in tag or "-pruned-" in tag:
                missing = set(r.shapes[tag]) - set(r.inputs)
                check(not missing, f"{tag}: no inputs kept for launch shapes {sorted(missing)}")
    log(f"files: peak device memory {out['collect_peak_bytes']} bytes (collect), "
        f"{out['stream0_peak_bytes']} / {out['stream1_peak_bytes']} (streamed, depth 0 / 1), "
        f"{out['cluster_peak_bytes']} (cluster)")
    out["launches"] = launches
    out["partition_launches"] = plaunches
    out["grouped_launches"] = glaunches
    return out


# -- phase 12: the operator's surface (shell, hints, ladder, REST, KEDA) -------

# (a): the queries the shell runs from its script
SHELL_QUERIES = ("q1", "q6", "q3")
# (b): queries whose cold runs retried over Parquet in run J10 (q2 once, q4
# twice): a fresh process seeded from the hint file must not retry
HINT_QUERIES = ("q2", "q4")
# (c): a coarser ladder than the default 2048:2
LADDER_SPEC = "4096:4"
LADDER_QUERIES = ("q1", "q6", "q18")
# (d, e): the cluster's jobs, through the process entries
OPS_QUERIES = ("q1", "q3")

# a child process of (b): a fresh TorchContext on the card over the Parquet
# files, each query of HINT_QUERIES run once (cold), its result written as
# Arrow IPC; prints one line "RESULT <json>" with seconds, retries and the
# kernels' launches a query
HINT_CHILD = r"""
import json, sys, time
import pyarrow as pa
import torch
from ballista_tpu_torch.exec.context import TorchContext
from ballista_tpu_torch.ops import onehot_agg, partition

spec = json.loads(sys.argv[1])
ctx = TorchContext(device="cuda")
for stmt in spec["ddl"]:
    ctx.sql(stmt)
out = {}
for q, sql in spec["queries"].items():
    onehot_agg.launches = partition.launches = partition.group_launches = 0
    t = time.perf_counter()
    df = ctx.sql(sql)
    res = df.collect()
    torch.cuda.synchronize()
    secs = time.perf_counter() - t
    with pa.OSFile(f"{spec['out']}/{q}.arrow", "wb") as f, pa.ipc.new_file(f, res.schema) as w:
        w.write_table(res)
    out[q] = dict(
        s=secs, capacity_retries=df.stats.get("capacity_retries", 0),
        speculation_misses=df.stats.get("speculation_misses", 0), launches=onehot_agg.launches,
        partition_launches=partition.launches + partition.group_launches,
    )
print("RESULT " + json.dumps(out), flush=True)
"""


def free_port() -> int:
    import socket

    with socket.socket() as so:
        so.bind(("127.0.0.1", 0))
        return so.getsockname()[1]


def child_env(hints: str) -> dict:
    """The environment of a child process: this one's, with its own hint
    cache (a directory, or ``off``)."""
    import os

    return {**os.environ, "BALLISTA_TPU_HINT_CACHE": hints}


def read_csv_blocks(text: str, counts: list) -> list:
    """Split the shell's ``--format csv -q`` output into one table a
    statement: each block is a header line and ``counts[i]`` rows."""
    import io

    import pyarrow.csv as pacsv

    lines = text.splitlines()
    out, i = [], 0
    for n in counts:
        block = "\n".join(lines[i:i + 1 + n]) + "\n"
        out.append(pacsv.read_csv(io.BytesIO(block.encode())))
        i += 1 + n
    check(i == len(lines), f"shell: {len(lines) - i} lines of output left over:\n{text[-2000:]}")
    return out


def as_types_of(got, want):
    """``got`` (read back from CSV) cast to ``want``'s schema."""
    import pyarrow as pa

    check(got.column_names == want.column_names, f"columns {got.column_names} vs {want.column_names}")
    return pa.Table.from_arrays(
        [got.column(c).cast(want.schema.field(c).type) for c in want.column_names], schema=want.schema
    )


def ops_path(data: dict, earlier: dict, files: dict, tmp: pathlib.Path, rec: LaunchRecorder,
             prec: PartitionRecorder, pkg_root: pathlib.Path) -> dict:
    """(a)-(e) of phase 12 over phase 11's Parquet files in ``tmp``:
    ``earlier`` maps a query to (SQL, the card's memory-table result of
    phases 4-6), ``files`` to phase 11 (a)'s result over the files."""
    import re
    import shutil
    import signal
    import tempfile
    import threading
    import urllib.request

    import grpc
    import pyarrow as pa
    import torch

    from ballista_tpu_torch.client.context import BallistaContext
    from ballista_tpu_torch.columnar.arrow_interop import batch_to_arrow
    from ballista_tpu_torch.columnar.batch import capacity_ladder, set_capacity_buckets
    from ballista_tpu_torch.config import BallistaConfig
    from ballista_tpu_torch.exec.base import execute_to_batches, run_with_capacity_retry
    from ballista_tpu_torch.exec.context import TorchContext
    from ballista_tpu_torch.exec.planner import PhysicalPlanner
    from ballista_tpu_torch.obs.prometheus import validate_exposition
    from ballista_tpu_torch.ops import onehot_agg, partition
    from ballista_tpu_torch.plan.optimizer import optimize
    from ballista_tpu_torch.proto import pb
    from ballista_tpu_torch.scheduler.external_scaler import EXTERNAL_SCALER_METHODS, EXTERNAL_SCALER_SERVICE

    out: dict = {}
    launches = plaunches = glaunches = 0
    work = pathlib.Path(tempfile.mkdtemp(prefix="chip_smoke_ops-"))
    ddl = [
        f"CREATE EXTERNAL TABLE {name} STORED AS PARQUET LOCATION '{tmp / f'{name}.parquet'}'" for name in data
    ]

    started: list = []

    def start(args: list, env: dict):
        """A child on the card, its output into files (several run at once)."""
        outs = [tempfile.TemporaryFile("w+"), tempfile.TemporaryFile("w+")]
        proc = subprocess.Popen(
            [sys.executable, *args], cwd=pkg_root, env=env, stdout=outs[0], stderr=outs[1], text=True
        )
        started.append(proc)
        return proc, outs, time.perf_counter()

    def finish(child, timeout: float = 300):
        """(the child's CompletedProcess, its wall seconds)."""
        proc, outs, t = child
        try:
            rc = proc.wait(timeout=timeout)
        except subprocess.TimeoutExpired:
            proc.kill()
            raise SmokeFailure(f"child {proc.args[1:3]} took over {timeout} s")
        secs = time.perf_counter() - t
        for f in outs:
            f.seek(0)
        return subprocess.CompletedProcess(proc.args, rc, outs[0].read(), outs[1].read()), secs

    hints = work / "hints"

    def hint_child(tag: str, cache: str):
        res_dir = work / f"hint-{tag}"
        res_dir.mkdir()
        spec = dict(ddl=ddl, queries={q: earlier[q][0] for q in HINT_QUERIES}, out=str(res_dir))
        return start(["-c", HINT_CHILD, json.dumps(spec)], child_env(cache))

    try:
        # (a) the shell as a child on the card: DDL, then q1, q6, q3; it
        # runs beside (b)'s first child and its child with the cache off,
        # which are independent of it and of each other
        t0 = time.perf_counter()
        script = work / "shell.sql"
        script.write_text(
            "".join(f"{s};\n" for s in ddl)
            + "".join(earlier[q][0].strip().rstrip(";") + ";\n" for q in SHELL_QUERIES)
        )
        shell = start(
            ["-m", "ballista_tpu_torch.cli", "-f", str(script), "--format", "csv", "-q", "--device", "cuda",
             "--batch-size", "8192"],
            child_env(str(work / "hints-shell")),
        )
        hint_children = {"first": hint_child("first", str(hints)), "off": hint_child("off", "off")}
        proc, secs = finish(shell)
        check(proc.returncode == 0 and "error:" not in proc.stdout,
              f"shell exited {proc.returncode}:\n{proc.stdout[-3000:]}\n{proc.stderr[-3000:]}")
        blocks = read_csv_blocks(proc.stdout, [1] * len(ddl) + [files[q].num_rows for q in SHELL_QUERIES])
        check(all(b.to_pydict() == {"result": ["ok"]} for b in blocks[:len(ddl)]), "shell: a DDL statement failed")
        for q, got in zip(SHELL_QUERIES, blocks[len(ddl):]):
            held_as(f"{q}-shell", q, as_types_of(got, files[q]), files[q], exact=False)
        out["shell"] = dict(s=secs, queries=list(SHELL_QUERIES), output_lines=len(proc.stdout.splitlines()))
        log(f"shell: ok  {json.dumps(out['shell'])}")
        out["shell_s"] = time.perf_counter() - t0

        # (b) persisted hints: two children over one fresh hint directory,
        # the second started when the first has ended, a third with the
        # cache off
        t0 = time.perf_counter()
        runs = {}
        for tag in ("first", "second", "off"):
            if tag == "second":
                hint_children["second"] = hint_child("second", str(hints))
            res_dir = work / f"hint-{tag}"
            proc, secs = finish(hint_children[tag])
            line = next((ln for ln in proc.stdout.splitlines() if ln.startswith("RESULT ")), None)
            check(proc.returncode == 0 and line is not None,
                  f"hint child {tag} exited {proc.returncode}:\n{proc.stdout[-2000:]}\n{proc.stderr[-3000:]}")
            runs[tag] = json.loads(line[len("RESULT "):])
            tables = {q: pa.ipc.open_file(str(res_dir / f"{q}.arrow")).read_all() for q in HINT_QUERIES}
            for q in HINT_QUERIES:
                held_as(f"{q}-hints-{tag}", q, tables[q], files[q], exact=False)
                runs[tag][q]["table"] = tables[q]
            size = (hints / "plan_hints.json").stat().st_size if (hints / "plan_hints.json").exists() else 0
            out[f"hints-{tag}"] = dict(
                child_s=secs, hint_file_bytes=size,
                **{q: {k: v for k, v in runs[tag][q].items() if k != "table"} for q in HINT_QUERIES},
            )
            log(f"hints-{tag}: ok  {json.dumps(out[f'hints-{tag}'])}")

        def retries(tag, q):
            return runs[tag][q]["capacity_retries"] + runs[tag][q]["speculation_misses"]

        check(out["hints-first"]["hint_file_bytes"] > 0, "hints: the first child wrote no plan_hints.json")
        for q in HINT_QUERIES:
            check(retries("second", q) == 0, f"{q}: the second child retried {retries('second', q)} times")
            check(runs["second"][q]["table"].equals(runs["first"][q]["table"]),
                  f"{q}: the second child's result differs from the first's")
            check(retries("off", q) == retries("first", q),
                  f"{q}: with the cache off {retries('off', q)} retries, the first child {retries('first', q)}")
        check(sum(retries("first", q) for q in HINT_QUERIES) > 0, "hints: the first child's cold runs did not retry")
        out["hints_s"] = time.perf_counter() - t0

        # (c) the capacity ladder: q1, q6, q18 over the memory tables
        # under LADDER_SPEC and under the default, and q3 through the
        # distributed planner in process (the partition-hash kernel)
        t0 = time.perf_counter()
        rec.keep = prec.keep = rec.keep_on_host = prec.keep_on_host = True
        ladders: dict = {}
        try:
            for spec in (LADDER_SPEC, ""):
                name = spec or "default"
                ctx = TorchContext(BallistaConfig({"ballista.tpu.capacity_buckets": spec} if spec else {}), device="cuda")
                check(capacity_ladder().spec() == (spec or "2048:2"), f"ladder {name}: {capacity_ladder().spec()}")
                for t, tab in data.items():
                    ctx.register_table(t, tab)
                sqls = {q: earlier[q][0] for q in LADDER_QUERIES + ("q3",)}
                for q in LADDER_QUERIES:
                    tag = f"{q}-ladder-{name}"
                    rec.tag = prec.tag = tag
                    rs = []
                    for _ in range(2):
                        onehot_agg.launches = partition.launches = partition.group_launches = 0
                        t = time.perf_counter()
                        df = ctx.sql(sqls[q])
                        res = df.collect()
                        torch.cuda.synchronize()
                        rs.append(dict(s=time.perf_counter() - t, table=res, launches=onehot_agg.launches,
                                       retries=df.stats.get("capacity_retries", 0)))
                        launches += onehot_agg.launches
                        plaunches += partition.launches
                        glaunches += partition.group_launches
                    rec.tag = prec.tag = None
                    held_as(tag, q, rs[1]["table"], earlier[q][1], exact=True)
                    check(rs[1]["retries"] == 0, f"{tag}: the warm run retried")
                    ladders[tag] = rs[1]["table"]
                    out[tag] = dict(cold_s=rs[0]["s"], warm_s=rs[1]["s"], capacity_retries=[r["retries"] for r in rs],
                                    onehot_launches=[r["launches"] for r in rs])
                    log(f"{tag}: ok  {json.dumps(out[tag])}")
                plan = PhysicalPlanner(ctx, 4, config=ctx.config, distributed=True).plan(
                    optimize(ctx.sql_to_logical(sqls["q3"]))
                )
                tag = f"q3-ladder-dist-{name}"
                rec.tag = prec.tag = tag
                partition.launches = partition.group_launches = onehot_agg.launches = 0
                t = time.perf_counter()
                res = pa.Table.from_batches(run_with_capacity_retry(
                    ctx.config,
                    lambda task: [rb for b in execute_to_batches(plan, task) if (rb := batch_to_arrow(b)).num_rows],
                    device="cuda",
                ))
                torch.cuda.synchronize()
                rec.tag = prec.tag = None
                launches += onehot_agg.launches
                plaunches += partition.launches
                glaunches += partition.group_launches
                compare_tables(tag, res, earlier["q3"][1])
                check(partition.launches > 0, f"{tag}: no partition-hash launch")
                ladders[tag] = res
                out[tag] = dict(s=time.perf_counter() - t, partition_launches=partition.launches)
                log(f"{tag}: ok  {json.dumps(out[tag])}")
                ctx.tables.clear()
                ctx._physical_cache.clear()
        finally:
            rec.tag = prec.tag = None
            rec.keep = prec.keep = rec.keep_on_host = prec.keep_on_host = False
            set_capacity_buckets("")
        check(capacity_ladder().spec() == "2048:2", "the default ladder was not restored")
        for q in LADDER_QUERIES:
            held_as(f"{q}-ladders", q, ladders[f"{q}-ladder-{LADDER_SPEC}"], ladders[f"{q}-ladder-default"], exact=True)
        compare_tables("q3-ladders-dist", ladders[f"q3-ladder-dist-{LADDER_SPEC}"], ladders["q3-ladder-dist-default"])
        torch.cuda.empty_cache()
        out["ladder_s"] = time.perf_counter() - t0

        # (d, e) the scheduler and two executors as process entries with
        # REST and metrics ports; q1 and q3 through a remote client
        t0 = time.perf_counter()
        procs: list = []

        def start(args: list):
            proc = subprocess.Popen(
                [sys.executable, "-m", *args], cwd=pkg_root, env=child_env("off"),
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
            )
            lines: list = []
            threading.Thread(target=lambda: lines.extend(proc.stdout), daemon=True).start()
            procs.append((args[0], proc, lines))
            return proc, lines

        def wait_for(lines, proc, pattern: str, what: str):
            deadline = time.time() + 90
            while time.time() < deadline and proc.poll() is None:
                m = re.search(pattern, "".join(lines))
                if m:
                    return m
                time.sleep(0.1)
            raise SmokeFailure(f"{what} did not start:\n" + "".join(lines[-40:]))

        rest_port, metrics_ports = free_port(), [free_port(), free_port()]
        client = None
        try:
            sched, sched_out = start([
                "ballista_tpu_torch.scheduler", "--bind-host", "127.0.0.1", "--bind-port", "0",
                "--rest-port", str(rest_port), "--executor-timeout-seconds", "30",
            ])
            port = int(wait_for(sched_out, sched, r"gRPC on 127\.0\.0\.1:(\d+)", "scheduler").group(1))
            wait_for(sched_out, sched, rf"REST /state on 127\.0\.0\.1:{rest_port}", "REST")
            execs = [start([
                "ballista_tpu_torch.executor", "--device", "cuda", "--bind-host", "127.0.0.1",
                "--external-host", "127.0.0.1", "--bind-port", "0", "--scheduler-host", "127.0.0.1",
                "--scheduler-port", str(port), "--concurrent-tasks", "2", "--metrics-port", str(mp),
                "--work-dir", str(work / f"exec{i}"),
            ]) for i, mp in enumerate(metrics_ports)]
            for (proc, lines), mp in zip(execs, metrics_ports):
                wait_for(lines, proc, rf"metrics on 127\.0\.0\.1:{mp}/api/metrics", "executor metrics")
            base = f"http://127.0.0.1:{rest_port}"

            def api(path: str):
                return json.load(urllib.request.urlopen(base + path, timeout=30))

            deadline = time.time() + 60
            while len(api("/api/state")["executors"]) < 2 and time.time() < deadline:
                time.sleep(0.2)
            check(len(api("/api/state")["executors"]) == 2, "the executors did not register")
            client = BallistaContext.remote("127.0.0.1", port, BallistaConfig(CLUSTER_SETTINGS), device="cuda")
            for s in ddl:
                check(client.sql(s).collect().to_pydict() == {"result": ["ok"]}, f"DDL: {s}")
            channel = grpc.insecure_channel(f"127.0.0.1:{port}")
            scaler = {
                name: channel.unary_unary(
                    f"/{EXTERNAL_SCALER_SERVICE}/{name}", request_serializer=lambda r: r.SerializeToString(),
                    response_deserializer=resp.FromString,
                )
                for name, (_req, resp) in EXTERNAL_SCALER_METHODS.items()
            }
            ref = pb.ScaledObjectRef(name="ballista")

            def is_active() -> bool:
                return scaler["IsActive"](ref, timeout=10).result

            check(not is_active(), "KEDA IsActive before any query")
            job_ids = {}
            for q in OPS_QUERIES:
                before = {j["job_id"] for j in api("/api/state")["jobs"]}
                done, box = threading.Event(), {}

                def run(q=q):
                    try:
                        t = time.perf_counter()
                        box["table"] = client.sql(earlier[q][0]).collect()
                        box["s"] = time.perf_counter() - t
                    except BaseException as e:  # noqa: BLE001 — re-raised below
                        box["error"] = e
                    finally:
                        done.set()

                th = threading.Thread(target=run)
                th.start()
                active, metric = False, 0
                while not done.is_set():
                    if is_active():
                        active = True
                        metric = max(metric, scaler["GetMetrics"](
                            pb.GetMetricsRequest(scaledObjectRef=ref), timeout=10).metricValues[0].metricValue)
                    time.sleep(0.02)
                th.join()
                if "error" in box:
                    raise box["error"]
                held_as(f"{q}-ops", q, box["table"], files[q], exact=True)
                check(active, f"{q}: KEDA IsActive never true while it ran")
                check(not is_active(), f"{q}: KEDA IsActive still true after it")
                (job_ids[q],) = {j["job_id"] for j in api("/api/state")["jobs"]} - before
                out[f"{q}-ops"] = dict(s=box["s"], keda_active_seen=active, keda_max_desired=metric)
                log(f"{q}-ops: ok  {json.dumps(out[f'{q}-ops'])}")
            channel.close()
            # the scheduler writes a job's terminal history row just after
            # its client sees it complete
            deadline = time.time() + 30
            while time.time() < deadline and sum(
                r["status"] == "completed" for r in api("/api/history")["rows"]
            ) < len(OPS_QUERIES):
                time.sleep(0.1)
            # the system tables, through the client (the scheduler's history)
            queries = client.sql("SELECT job_id, status, query_class, wall_seconds FROM system.queries").collect()
            rows = {r["job_id"]: r for r in queries.to_pylist()}
            check(set(job_ids.values()) <= set(rows), f"system.queries: {queries.to_pydict()}")
            check(all(rows[j]["status"] == "completed" and rows[j]["wall_seconds"] > 0 for j in job_ids.values()),
                  f"system.queries: {queries.to_pydict()}")
            attempts = client.sql("SELECT job_id, stage_id, partition, state FROM system.task_attempts").collect()
            for q, j in job_ids.items():
                detail = api(f"/api/job/{j}")
                check(detail["status"] == "completed" and detail["stages"], f"/api/job/{j}: {detail.get('status')}")
                got = sum(1 for r in attempts.to_pylist() if r["job_id"] == j and r["state"] == "completed")
                check(got >= len(detail["stages"]), f"system.task_attempts: {got} completed attempts of {q}")
                out[f"{q}-ops"].update(job_id=j, stages=len(detail["stages"]), attempts=got)
            executors = client.sql("SELECT id, alive, task_slots FROM system.executors").collect()
            check(executors.num_rows == 2 and all(executors.column("alive").to_pylist()),
                  f"system.executors: {executors.to_pydict()}")
            history = api("/api/history")
            check(sum(r["status"] == "completed" for r in history["rows"]) >= len(OPS_QUERIES), f"/api/history: {history}")
            sched_metrics = urllib.request.urlopen(base + "/api/metrics", timeout=30).read().decode()
            validate_exposition(sched_metrics)
            check(f'ballista_jobs{{status="completed"}} {len(OPS_QUERIES)}' in sched_metrics,
                  "scheduler metrics: completed jobs")
            check("ballista_executors_alive 2" in sched_metrics, "scheduler metrics: alive executors")
            scrapes = []
            for mp in metrics_ports:
                text = urllib.request.urlopen(f"http://127.0.0.1:{mp}/api/metrics", timeout=30).read().decode()
                validate_exposition(text)
                m = re.search(r'ballista_executor_task_run_seconds_count\{class="[^"]*"\} (\d+)', text)
                scrapes.append(dict(bytes=len(text), task_runs=int(m.group(1)) if m else 0))
            check(sum(s["task_runs"] for s in scrapes) > 0, f"executor scrapes: {scrapes}")
            out["ops"] = dict(
                system_queries=queries.num_rows, system_attempts=attempts.num_rows,
                system_executors=executors.num_rows, history_rows=len(history["rows"]),
                scheduler_metrics_bytes=len(sched_metrics), executor_scrapes=scrapes,
            )
            log(f"ops: ok  {json.dumps(out['ops'])}")
        finally:
            if client is not None:
                client.close()
            stops = {}
            for name, proc, lines in reversed(procs):
                if proc.poll() is None:
                    t = time.perf_counter()
                    proc.send_signal(signal.SIGTERM)
                    try:
                        rc = proc.wait(timeout=15)
                    except subprocess.TimeoutExpired:
                        proc.kill()
                        proc.wait(timeout=30)
                        rc = None
                    stops.setdefault(name, []).append((rc, time.perf_counter() - t))
            out["ops_stops"] = stops
        check(all(rc == 0 for v in stops.values() for rc, _ in v), f"process entries on SIGTERM: {stops}")
        out["ops_s"] = time.perf_counter() - t0
    finally:
        for proc in started:
            if proc.poll() is None:
                proc.kill()
                proc.wait(timeout=30)
        shutil.rmtree(work, ignore_errors=True)
    for r in (rec, prec):
        for tag in r.shapes:
            if "-ladder-" in tag:
                missing = set(r.shapes[tag]) - set(r.inputs)
                check(not missing, f"{tag}: no inputs kept for launch shapes {sorted(missing)}")
    out["launches"] = launches
    out["partition_launches"] = plaunches
    out["grouped_launches"] = glaunches
    return out


def process_cluster(pkg_root: pathlib.Path) -> dict:
    """``python -m ballista_tpu_torch.scheduler`` and ``python -m
    ballista_tpu_torch.executor --device cuda``, push-staged: the executor
    registers and heartbeats, a remote client opens a session, and both
    processes exit 0 within 10 s of a SIGTERM."""
    import re
    import shutil
    import signal
    import tempfile
    import threading

    import grpc

    from ballista_tpu_torch.client.context import BallistaContext
    from ballista_tpu_torch.proto import pb
    from ballista_tpu_torch.scheduler.rpc import scheduler_stub

    def start(args: list):
        proc = subprocess.Popen(
            [sys.executable, "-m", *args], cwd=pkg_root,
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        )
        lines: list = []
        threading.Thread(target=lambda: lines.extend(proc.stdout), daemon=True).start()
        return proc, lines

    work = tempfile.mkdtemp(prefix="ballista_cluster_proc-")
    sched, sched_out = start([
        "ballista_tpu_torch.scheduler", "--bind-host", "127.0.0.1", "--bind-port", "0",
        "--scheduler-policy", "push-staged", "--executor-timeout-seconds", "30",
    ])
    ex = None
    out: dict = {}
    try:
        deadline = time.time() + 60
        port = None
        while port is None and time.time() < deadline and sched.poll() is None:
            m = re.search(r"gRPC on 127\.0\.0\.1:(\d+)", "".join(sched_out))
            port = int(m.group(1)) if m else None
            time.sleep(0.1)
        check(port is not None, "scheduler process did not start:\n" + "".join(sched_out[-40:]))
        ex, ex_out = start([
            "ballista_tpu_torch.executor", "--device", "cuda", "--bind-host", "127.0.0.1",
            "--external-host", "127.0.0.1", "--bind-port", "0", "--bind-grpc-port", "0",
            "--scheduler-host", "127.0.0.1", "--scheduler-port", str(port),
            "--task-scheduling-policy", "push-staged", "--concurrent-tasks", "1", "--work-dir", work,
        ])
        roster: list = []
        first = beat = None
        with grpc.insecure_channel(f"127.0.0.1:{port}") as ch:
            stub = scheduler_stub(ch)
            deadline = time.time() + 60
            # registered (the roster's first sighting), then a heartbeat
            # (its last sighting moves on; the executor beats every 15 s)
            while beat is None and time.time() < deadline and ex.poll() is None:
                roster = json.loads(stub.GetHistory(pb.GetHistoryParams(kind="executors")).payload or b"[]")
                if roster and roster[0]["alive"]:
                    seen = time.time() - roster[0]["last_heartbeat_age_s"]
                    if first is None:
                        first = seen
                    elif seen > first + 1.0:
                        beat = seen - first
                time.sleep(0.5)
        check(ex.poll() is None, "executor process exited early:\n" + "".join(ex_out[-40:]))
        check(len(roster) == 1 and beat is not None,
              f"executor process: roster {roster}, heartbeat after registration {beat}")
        client = BallistaContext.remote("127.0.0.1", port, device="cuda")
        try:
            check(bool(client.session_id), "remote client: no session")
            out["session"] = client.session_id
        finally:
            client.close()
        stops = {}
        for name, proc, lines in (("executor", ex, ex_out), ("scheduler", sched, sched_out)):
            t = time.perf_counter()
            proc.send_signal(signal.SIGTERM)
            rc = proc.wait(timeout=10)
            stops[name] = time.perf_counter() - t
            check(rc == 0, f"{name} process exited {rc} on SIGTERM:\n" + "".join(lines[-40:]))
        out.update(
            roster=roster, heartbeat_after_s=beat, stop_s=stops,
            device_line=next((line.strip() for line in ex_out if "device=cuda" in line), ""),
        )
        log(f"cluster processes: ok  {json.dumps(out)}")
    finally:
        for proc in (ex, sched):
            if proc is not None and proc.poll() is None:
                proc.kill()
                proc.wait(timeout=30)
        shutil.rmtree(work, ignore_errors=True)
    return out


# -- phase 13: adaptive query execution on the card --------------------------

# phase 10's cluster (K = 4) with AQE on, and eager shuffle off as in the
# reference's adaptive-loop test: eager consumers claim a pending stage's
# tasks early and close the window of a reactive rewrite
AQE_SETTINGS = {**CLUSTER_SETTINGS, "ballista.tpu.aqe": "true", "ballista.tpu.eager_shuffle": "false"}
AQE_OFF_SETTINGS = {**CLUSTER_SETTINGS, "ballista.tpu.eager_shuffle": "false"}
# (a): the reference's wrong-side build (tests/test_aqe.py) at 6M fact rows:
# dim JOIN fact puts the fact table on the build side of a string-keyed
# collect join. (TPC-H's supplier JOIN lineitem plans as a partitioned join,
# which no flip applies to, on the reference's cluster as on the port's.)
AQE_FACT_ROWS = 6_000_000
WRONG_BUILD_SQL = (
    "SELECT f.key, count(*) AS c, sum(f.v) AS s "
    "FROM dim d JOIN fact f ON d.skey = f.skey "
    "GROUP BY f.key ORDER BY s DESC LIMIT 20"
)


def skewed_tables(n_fact: int, n_dim: int = 400, seed: int = 7, int_keys: bool = False) -> dict:
    """The reference test's ``_skewed_tables``: a fact table of Zipf(1.5)
    int64 keys capped at 2000, string join keys ``s<key mod 4*n_dim>`` and
    uniform values in [0, 100); a dimension of ``s0``..``s<n_dim - 1>``.
    With ``int_keys`` the join key is the integer ``ikey`` (``key mod
    4*n_dim`` on the fact, 0..n_dim - 1 on the dimension: the same pairs)
    in place of ``skey``."""
    import numpy as np
    import pyarrow as pa

    rng = np.random.default_rng(seed)
    key = np.minimum(rng.zipf(1.5, size=n_fact), 2000).astype(np.int64)
    if int_keys:
        fkey, dkey = ("ikey", pa.array(key % (n_dim * 4))), ("ikey", pa.array(np.arange(n_dim, dtype=np.int64)))
    else:
        vocab = np.array([f"s{i}" for i in range(n_dim * 4)])
        fkey = ("skey", pa.array(vocab[key % (n_dim * 4)]))
        dkey = ("skey", pa.array([f"s{i}" for i in range(n_dim)]))
    fact = pa.table({"key": pa.array(key), fkey[0]: fkey[1], "v": pa.array(rng.uniform(0, 100, n_fact))})
    dim = pa.table({dkey[0]: dkey[1], "attr": pa.array((np.arange(n_dim) % 7).astype(np.int64))})
    return {"fact": fact, "dim": dim}


def max_rel_diff(got, want) -> float:
    """Largest relative difference of two float columns."""
    import numpy as np

    a, b = got.to_numpy(), want.to_numpy()
    return float(np.max(np.abs(a - b) / np.maximum(np.abs(b), 1e-300))) if len(b) else 0.0


def aqe_path(data: dict, oracles: dict, collected: dict, rec: LaunchRecorder,
             prec: PartitionRecorder) -> dict:
    """(a)-(d) of phase 13: AQE on the port's cluster, two executors on the
    card. ``collected``: collect mode's results of the five cluster
    queries. The strategy store persists into a new hint directory, which
    is deleted at the end; hints are ``off`` again after the phase."""
    import os
    import shutil
    import tempfile

    import torch

    from ballista_tpu_torch.client.context import BallistaContext
    from ballista_tpu_torch.config import BallistaConfig
    from ballista_tpu_torch.obs import prometheus as prom
    from ballista_tpu_torch.ops import onehot_agg, partition
    from ballista_tpu_torch.scheduler import aqe

    sqls = {q: (ROOT / "benchmarks" / "queries" / f"{q}.sql").read_text() for q in CLUSTER_QUERIES}
    t0 = time.perf_counter()
    skew = skewed_tables(AQE_FACT_ROWS)
    out: dict = {"tables_s": time.perf_counter() - t0}
    launches = plaunches = glaunches = 0

    def cluster(settings: dict, tables: dict) -> BallistaContext:
        ctx = BallistaContext.standalone(
            BallistaConfig(settings), device="cuda", n_executors=2, concurrent_tasks=2
        )
        for name, tab in tables.items():
            ctx.register_table(name, tab)
        return ctx

    def one_run(ctx, sql: str, tag: str) -> dict:
        """One query through the cluster, its counts set to 0 just before
        and read just after; its decisions, rewrites and grouped K."""
        nonlocal launches, plaunches, glaunches
        sched = ctx._standalone_cluster.scheduler
        seen = len(prec.shapes.get(tag, []))
        onehot_agg.launches = partition.launches = partition.group_launches = 0
        jobs0 = set(sched.jobs)
        rec.tag = prec.tag = tag
        try:
            t = time.perf_counter()
            res = ctx.sql(sql).collect()
            torch.cuda.synchronize()
            secs = time.perf_counter() - t
        finally:
            rec.tag = prec.tag = None
        launches += onehot_agg.launches
        plaunches += partition.launches
        glaunches += partition.group_launches
        (job_id,) = set(sched.jobs) - jobs0
        job = sched.jobs[job_id]
        check(job.status == "completed", f"{tag}: job {job_id} {job.status} {job.error}")
        grouped = [k for _, _, k, m in prec.shapes.get(tag, [])[seen:] if m == "grouped"]
        return dict(
            s=secs, table=res, stages=len(job.stages), rewrites=job.total_rewrites,
            rejects=job.total_rewrite_rejects,
            decisions=[
                {k: d[k] for k in ("op", "source", "outcome", "stage_ids", "clause", "before")}
                for d in job.aqe_decisions
            ],
            launches=onehot_agg.launches, plaunches=partition.launches, glaunches=partition.group_launches,
            grouped_K=sorted(set(grouped)),
        )

    def brief(r: dict) -> dict:
        return {k: v for k, v in r.items() if k != "table"}

    def learned_only(tag: str, r: dict) -> None:
        """A submission of a known class: every decision is a learned
        strategy, at least one applied, and each applied one counted."""
        applied = [d for d in r["decisions"] if d["outcome"] == "applied"]
        check(
            bool(applied) and all(d["source"] == "learned" for d in r["decisions"]),
            f"{tag}: not only learned decisions: {r['decisions']}",
        )
        check(r["rewrites"] == len(applied), f"{tag}: {r['rewrites']} rewrites, {len(applied)} applied")
        check(any(d["op"] == "flip" for d in applied), f"{tag}: no learned flip applied")

    hint_dir = tempfile.mkdtemp(prefix="chip_smoke_aqe-")
    os.environ["BALLISTA_TPU_HINT_CACHE"] = hint_dir
    aqe.reset_store()
    torch.cuda.reset_peak_memory_stats()
    rec.keep = prec.keep = rec.keep_on_host = prec.keep_on_host = True
    try:
        # (a) the wrong-side build, AQE off then on
        t0 = time.perf_counter()
        ctx = cluster(AQE_OFF_SETTINGS, skew)
        try:
            off = [one_run(ctx, WRONG_BUILD_SQL, "wrong-build-off") for _ in range(3)]
        finally:
            ctx.close()
        base = off[1]["table"]
        check(not any(r["decisions"] or r["rewrites"] for r in off), "AQE off: a decision was made")
        # keys and counts bit for bit; SUM(v) (no decimal scale) takes its
        # prefix from the fixed-order kernel: the two warm runs bit for bit,
        # the cold run within rtol 1e-9 (its batches may differ)
        for i in (0, 2):
            compare_tables(f"wrong-build-off run {i + 1}", off[i]["table"], base)
            check(off[i]["table"].drop(["s"]).equals(base.drop(["s"])), f"wrong-build-off run {i + 1}: keys differ")
        check(off[2]["table"].equals(base), "wrong-build-off: the two warm runs' SUM(v) differ")
        out["off_s_spread"] = max_rel_diff(off[2]["table"].column("s"), base.column("s"))
        ctx = cluster(AQE_SETTINGS, {**skew, **data})
        try:
            on = [one_run(ctx, WRONG_BUILD_SQL, "wrong-build-aqe") for _ in range(3)]
            flips = [d for d in on[0]["decisions"] if d["op"] == "flip" and d["outcome"] == "applied"]
            check(
                bool(flips) and flips[0]["source"] == "reactive"
                and flips[0]["before"]["build_bytes"] > flips[0]["before"]["probe_bytes"],
                f"wrong-build run 1: no reactive flip of a larger build: {on[0]['decisions']}",
            )
            for i, r in enumerate(on):
                if i:
                    learned_only(f"wrong-build run {i + 1}", r)
                # keys and counts bit for bit, SUM(v) within rtol 1e-9
                compare_tables(f"wrong-build-aqe run {i + 1}", r["table"], base)
                check(r["table"].drop(["s"]).equals(base.drop(["s"])), f"wrong-build-aqe run {i + 1}: keys differ")
            out["wrong_build"] = dict(
                fact_rows=AQE_FACT_ROWS, off=[brief(r) for r in off], on=[brief(r) for r in on],
                off_warm_s=[r["s"] for r in off[1:]], on_warm_s=[r["s"] for r in on[1:]],
                off_s_spread=out["off_s_spread"],
                on_s_off_by=[max_rel_diff(r["table"].column("s"), base.column("s")) for r in on],
            )
            log(f"aqe (a) wrong-build: ok  {json.dumps(out['wrong_build'])}")
            out["a_s"] = time.perf_counter() - t0

            # (b) phase 10's queries but q18, twice each
            t0 = time.perf_counter()
            for q in STAGED_QUERIES:
                runs = [one_run(ctx, sqls[q], f"{q}-aqe") for _ in range(2)]
                for i, r in enumerate(runs):
                    tag = f"{q}-aqe run {i + 1}"
                    res, want = r["table"], collected[q]
                    compare_tables(tag, res, want)
                    for c in STAGED_EXACT.get(q, ()):
                        check(res.column(c).equals(want.column(c)), f"{tag}: {c} not bit for bit")
                    if q in oracles:
                        compare(tag, res, oracles[q])
                check(runs[0]["glaunches"] > 0, f"{q}-aqe: no grouped launch")
                out[f"{q}-aqe"] = [brief(r) for r in runs]
                log(f"aqe (b) {q}: ok  {json.dumps(out[f'{q}-aqe'])}")
            out["b_s"] = time.perf_counter() - t0

            # (c) the kill switch over a session that asks for AQE, with
            # (a)'s and (b)'s strategies in the store: the wrong-side
            # build as AQE off runs it, and q3 (every column exact: keys,
            # dates and an exact decimal sum) bit for bit collect mode's
            t0 = time.perf_counter()
            os.environ["BALLISTA_AQE"] = "0"
            try:
                killed = [one_run(ctx, WRONG_BUILD_SQL, "wrong-build-killed"), one_run(ctx, sqls["q3"], "q3-killed")]
            finally:
                del os.environ["BALLISTA_AQE"]
            for r in killed:
                check(
                    not r["decisions"] and r["rewrites"] == r["rejects"] == 0,
                    f"BALLISTA_AQE=0: {r['decisions']}",
                )
            compare_tables("wrong-build-killed", killed[0]["table"], base)
            check(killed[0]["table"].drop(["s"]).equals(base.drop(["s"])), "wrong-build-killed: keys differ")
            check(killed[0]["stages"] == off[1]["stages"], "wrong-build-killed: not AQE off's stages")
            check(killed[1]["table"].equals(collected["q3"]), "q3 with BALLISTA_AQE=0: not bit for bit AQE off's")
            out["killed"] = [brief(r) for r in killed]
            log(f"aqe (c) BALLISTA_AQE=0: ok  {json.dumps(out['killed'])}")
            out["c_s"] = time.perf_counter() - t0

            sched = ctx._standalone_cluster.scheduler
            text = prom.render(prom.scheduler_families(sched))
            prom.validate_exposition(text)
            out["prometheus"] = [
                line for line in text.splitlines()
                if line.startswith(("ballista_aqe_rewrites_total", "ballista_plan_rewrite"))
            ]
            check(
                any(line.startswith('ballista_aqe_rewrites_total{op="flip",outcome="applied"}')
                    for line in out["prometheus"]),
                f"no applied flip in the scrape: {out['prometheus']}",
            )
            with sched._lock:
                jobs = list(sched.jobs.values())
            out["rewrites"] = sum(j.total_rewrites for j in jobs)
            out["rewrite_rejects"] = sum(j.total_rewrite_rejects for j in jobs)
            log(f"aqe: {out['rewrites']} rewrites accepted, {out['rewrite_rejects']} rejected; "
                f"scrape: {json.dumps(out['prometheus'])}")
        finally:
            ctx.close()

        # (d) a new scheduler over the same hint directory, the process's
        # store dropped: its first submission applies (a)'s strategies
        t0 = time.perf_counter()
        aqe.reset_store()
        ctx = cluster(AQE_SETTINGS, skew)
        try:
            fresh = one_run(ctx, WRONG_BUILD_SQL, "wrong-build-fresh")
        finally:
            ctx.close()
        learned_only("fresh cluster", fresh)
        compare_tables("wrong-build-fresh", fresh["table"], base)
        out["fresh"] = brief(fresh)
        out["hint_file_bytes"] = os.path.getsize(os.path.join(hint_dir, "plan_hints.json"))
        log(f"aqe (d) fresh cluster: ok  {json.dumps(out['fresh'])}; "
            f"plan_hints.json {out['hint_file_bytes']} bytes")
        out["d_s"] = time.perf_counter() - t0
    finally:
        rec.tag = prec.tag = None
        rec.keep = prec.keep = rec.keep_on_host = prec.keep_on_host = False
        os.environ["BALLISTA_TPU_HINT_CACHE"] = "off"
        aqe.reset_store()
        shutil.rmtree(hint_dir, ignore_errors=True)
    peak = torch.cuda.max_memory_allocated()
    log(f"aqe: peak device memory {peak} bytes ({peak / 2**30:.3f} GiB)")
    for r in (rec, prec):
        for tag in r.shapes:
            if tag.endswith("-aqe") or tag.startswith("wrong-build"):
                missing = set(r.shapes[tag]) - set(r.inputs)
                check(not missing, f"{tag}: no inputs kept for launch shapes {sorted(missing)}")
    out["launches"] = launches
    out["partition_launches"] = plaunches
    out["grouped_launches"] = glaunches
    out["peak_bytes"] = peak
    return out


# -- phase 14: UDF and UDAF plugins on the card --------------------------------

# The port's plugin (torch bodies): two scalar UDFs and two algebraic UDAFs,
# geo_mean (SUM of log x and a COUNT) and spread (MAX, MIN and a COUNT).
PLUGIN_SOURCE = '''
import torch
from ballista_tpu_torch.datatypes import DataType


def register(register_udf, register_udaf):
    register_udf("squareplus", lambda x, y: x * x + y, DataType.FLOAT64,
                 min_args=2, max_args=2)
    register_udf("clamp01", lambda x: torch.clamp(x, 0.0, 1.0), DataType.FLOAT64)
    register_udaf(
        "geo_mean",
        states=[("slog", "sum", lambda x: torch.log(x)), ("n", "count", None)],
        finalize=lambda s, n: torch.exp(s / torch.clamp(n, min=1).to(torch.float64)),
    )
    register_udaf(
        "spread",
        states=[("hi", "max", None), ("lo", "min", None), ("n", "count", None)],
        finalize=lambda hi, lo, n: hi - lo,
    )
'''
PLUGIN_DENSE_SQL = (
    "SELECT l_returnflag, l_linestatus, geo_mean(l_extendedprice) AS gm, "
    "spread(l_quantity) AS sp, SUM(squareplus(l_discount, l_tax)) AS sq "
    "FROM lineitem WHERE clamp01(l_discount * 10) < 1 "
    "GROUP BY l_returnflag, l_linestatus ORDER BY 1, 2"
)
PLUGIN_SORT_SQL = (
    "SELECT l_suppkey, geo_mean(l_extendedprice) AS gm, COUNT(*) AS c "
    "FROM lineitem GROUP BY l_suppkey ORDER BY gm DESC, l_suppkey LIMIT 20"
)


def plugin_oracles(li) -> dict:
    """numpy oracles of the two plugin queries over lineitem: f64 sums by
    ``np.add.at``, MAX/MIN exact, counts exact."""
    import numpy as np

    q, p, d, t = (li.column(c).to_numpy() for c in ("l_quantity", "l_extendedprice", "l_discount", "l_tax"))
    rf, ls = host_strings(li.column("l_returnflag")), host_strings(li.column("l_linestatus"))
    keep = np.minimum(np.maximum(d * 10, 0.0), 1.0) < 1
    pairs, inv = np.unique(np.char.add(rf[keep], ls[keep]), return_inverse=True)
    g = len(pairs)
    slog, n, sq = np.zeros(g), np.zeros(g), np.zeros(g)
    np.add.at(slog, inv, np.log(p[keep]))
    np.add.at(n, inv, 1.0)
    np.add.at(sq, inv, d[keep] * d[keep] + t[keep])
    hi, lo = np.full(g, -np.inf), np.full(g, np.inf)
    np.maximum.at(hi, inv, q[keep])
    np.minimum.at(lo, inv, q[keep])
    dense = {
        "l_returnflag": [s[0] for s in pairs], "l_linestatus": [s[1] for s in pairs],
        "gm": np.exp(slog / n), "sp": hi - lo, "sq": sq,
    }
    supp = li.column("l_suppkey").to_numpy()
    keys, inv = np.unique(supp, return_inverse=True)
    slog, n = np.zeros(len(keys)), np.zeros(len(keys))
    np.add.at(slog, inv, np.log(p))
    np.add.at(n, inv, 1.0)
    gm = np.exp(slog / n)
    top = np.lexsort((keys, -gm))[:20]
    sort = {"l_suppkey": keys[top].tolist(), "gm": gm[top], "c": n[top].astype(np.int64).tolist()}
    return {"dense": dense, "sort": sort}


def plugin_path(data: dict, rec: "LaunchRecorder", prec: "PartitionRecorder") -> dict:
    """Phase 14: a port plugin file written into a new ``ballista.plugin_dir``
    (deleted at the end); (a) ``TorchContext(device="cuda")`` with it runs
    the dense and the sort-path query cold and twice warm; (b) the port's
    cluster (two executors on the card, K = 4) with the directory as a
    session setting runs both the same way, and the sort-path query once
    more through ``functions.udaf`` in the DataFrame builder. Every run is
    held against the numpy oracles (rtol 1e-9, keys and counts exact), (b)
    against (a), two warm runs bit for bit and no warm run retrying; the
    dense query must launch the one-hot kernel, the sort-path one the
    prefix-sum kernel; every task of (b) loads the plugin directory."""
    import shutil
    import tempfile

    import torch

    from ballista_tpu_torch import functions as F
    from ballista_tpu_torch import plugin
    from ballista_tpu_torch.client.context import BallistaContext
    from ballista_tpu_torch.config import BallistaConfig
    from ballista_tpu_torch.exec.context import TorchContext
    from ballista_tpu_torch.ops import onehot_agg, partition, prefix_sum

    t0 = time.perf_counter()
    oracles = plugin_oracles(data["lineitem"])
    out: dict = {"oracles_s": time.perf_counter() - t0}
    sqls = {"dense": PLUGIN_DENSE_SQL, "sort": PLUGIN_SORT_SQL}
    plugin_dir = tempfile.mkdtemp(prefix="chip_smoke_plugins-")
    (pathlib.Path(plugin_dir) / "smoke_fns.py").write_text(PLUGIN_SOURCE)
    launches = {"onehot": 0, "prefix": 0, "partition": 0, "grouped": 0}
    # every call of the loader, the tasks' among them
    loads: list = []
    real_load = plugin.load_plugins

    def counted_load(d=None):
        loads.append(d)
        return real_load(d)

    def one_run(tag: str, run) -> dict:
        onehot_agg.launches = partition.launches = partition.group_launches = 0
        p0 = prefix_sum.launches
        rec.tag = prec.tag = tag
        try:
            t = time.perf_counter()
            res, stats = run()
            torch.cuda.synchronize()
            secs = time.perf_counter() - t
        finally:
            rec.tag = prec.tag = None
        r = dict(s=secs, table=res, retries=stats, launches=onehot_agg.launches,
                 plaunches=prefix_sum.launches - p0, hlaunches=partition.launches,
                 glaunches=partition.group_launches)
        launches["onehot"] += r["launches"]
        launches["prefix"] += r["plaunches"]
        launches["partition"] += r["hlaunches"]
        launches["grouped"] += r["glaunches"]
        return r

    def held(tag: str, kind: str, runs: list) -> dict:
        for i, r in enumerate(runs):
            compare(f"{tag} run {i}", r["table"], oracles[kind])
        check(runs[-1]["table"].equals(runs[-2]["table"]), f"{tag}: two warm runs differ")
        check(not any(sum(r["retries"].values()) for r in runs[1:]), f"{tag}: a warm run retried")
        return dict(
            cold_s=runs[0]["s"], warm_s=[r["s"] for r in runs[1:]],
            onehot_launches=[r["launches"] for r in runs], prefix_launches=[r["plaunches"] for r in runs],
            partition_launches=[r["hlaunches"] for r in runs], grouped_launches=[r["glaunches"] for r in runs],
            retries=[r["retries"] for r in runs],
            onehot_shapes=sorted(set(rec.shapes.get(tag, []))),
            prefix_shapes=sorted(set(rec.prefix_shapes.get(tag, []))),
        )

    torch.cuda.reset_peak_memory_stats()
    plugin.load_plugins = counted_load
    rec.keep = prec.keep = rec.keep_on_host = prec.keep_on_host = rec.keep_prefix = True
    local: dict = {}
    try:
        # (a) the local context loads the directory at construction
        t0 = time.perf_counter()
        ctx = TorchContext(BallistaConfig({"ballista.plugin_dir": plugin_dir}), device="cuda")
        ctx.register_table("lineitem", data["lineitem"])
        check(plugin.global_registry.get_udaf("geo_mean") is not None, "the context loaded no plugin")

        def local_run(sql):
            df = ctx.sql(sql)
            res = df.collect()
            return res, {k: df.stats.get(k, 0) for k in ("capacity_retries", "speculation_misses")}

        for kind, sql in sqls.items():
            tag = f"plugin-{kind}"
            runs = [one_run(tag, lambda: local_run(sql)) for _ in range(3)]
            out[tag] = held(tag, kind, runs)
            local[kind] = runs[-1]["table"]
            log(f"{tag}: ok  {json.dumps(out[tag])}")
        check(min(out["plugin-dense"]["onehot_launches"]) > 0, "plugin-dense: no one-hot launch")
        check(min(out["plugin-sort"]["prefix_launches"]) > 0, "plugin-sort: no prefix-sum launch")
        out["a_s"] = time.perf_counter() - t0

        # (b) the port's cluster: the directory is a session setting that
        # the scheduler and every task load
        t0 = time.perf_counter()
        del loads[:]
        settings = {"ballista.shuffle.partitions": str(STAGED_K), "ballista.plugin_dir": plugin_dir}
        cl = BallistaContext.standalone(BallistaConfig(settings), device="cuda", n_executors=2, concurrent_tasks=2)
        try:
            cl.register_table("lineitem", data["lineitem"])
            sched = cl._standalone_cluster.scheduler
            tasks: list = []  # the tasks of each run
            with RetryCounter() as retries:

                def cluster_run(run):
                    retries.counts.clear()
                    jobs0 = set(sched.jobs)
                    res = run()
                    (job_id,) = set(sched.jobs) - jobs0
                    job = sched.jobs[job_id]
                    check(job.status == "completed", f"plugin cluster job {job_id}: {job.status} {job.error}")
                    tasks.append(sum(len(st["tasks"]) for st in job.stage_stats or []))
                    return res, dict(retries.counts)

                builder = (
                    lambda: cl.table("lineitem")
                    .aggregate(["l_suppkey"], [F.udaf("geo_mean", "l_extendedprice").alias("gm"),
                                               F.count_star().alias("c")])
                    .sort(F.col("gm").sort(False), F.col("l_suppkey"))
                    .limit(20).collect()
                )
                for kind, run in (
                    ("dense", lambda: cl.sql(PLUGIN_DENSE_SQL).collect()),
                    ("sort", lambda: cl.sql(PLUGIN_SORT_SQL).collect()),
                    ("builder", builder),
                ):
                    tag = f"plugin-{kind}-cluster"
                    n = 3 if kind != "builder" else 1
                    runs = [one_run(tag, lambda: cluster_run(run)) for _ in range(n)]
                    want_kind = "sort" if kind == "builder" else kind
                    for i, r in enumerate(runs):
                        compare_tables(f"{tag} run {i}", r["table"], local[want_kind])
                        compare(f"{tag} run {i}", r["table"], oracles[want_kind])
                    if n > 1:
                        out[tag] = held(tag, want_kind, runs)
                    else:
                        out[tag] = dict(s=runs[0]["s"], prefix_launches=runs[0]["plaunches"],
                                        onehot_launches=runs[0]["launches"])
                    check(sum(r["glaunches"] for r in runs) > 0, f"{tag}: no grouped launch")
                    log(f"{tag}: ok  {json.dumps(out[tag])}")
            out["task_loads"] = sum(1 for d in loads if d == plugin_dir)
            out["tasks"] = sum(tasks)
        finally:
            cl.close()
        check(
            out["tasks"] > 0 and out["task_loads"] >= out["tasks"],
            f"plugin cluster: {out['task_loads']} loads of the plugin directory for {out['tasks']} tasks",
        )
        check(min(out["plugin-sort-cluster"]["prefix_launches"]) > 0, "plugin-sort-cluster: no prefix-sum launch")
        check(min(out["plugin-dense-cluster"]["onehot_launches"]) > 0, "plugin-dense-cluster: no one-hot launch")
        out["b_s"] = time.perf_counter() - t0
    finally:
        plugin.load_plugins = real_load
        rec.tag = prec.tag = None
        rec.keep = prec.keep = rec.keep_on_host = prec.keep_on_host = rec.keep_prefix = False
        shutil.rmtree(plugin_dir, ignore_errors=True)
    peak = torch.cuda.max_memory_allocated()
    log(f"plugins: loads {out['task_loads']}, launches {json.dumps(launches)}, "
        f"peak device memory {peak} bytes ({peak / 2**30:.3f} GiB)")
    out.update(launches=launches["onehot"], prefix_launches=launches["prefix"],
               partition_launches=launches["partition"], grouped_launches=launches["grouped"],
               peak_bytes=peak)
    return out


# -- phase 15: the join build-table cache and the learned flip ----------------

# TPC-H queries whose collect-mode joins build tables a warm run can keep:
# q18's SEMI build over its HAVING subquery, q8's and q5's chains of
# dimension builds, q17's build of part, q3's builds of customer and orders
CACHE_QUERIES = ("q18", "q8", "q17", "q3", "q5")
# phase 13 (a)'s wrong-side build with an integer join key
# (``skewed_tables(..., int_keys=True)``: the string join's own pairs), on
# one TorchContext: the fact, on the right, repeats its keys and the
# dimension does not, so from the second run on the flip is learned and the
# fact is streamed through the dimension's table without being collected
CACHE_FLIP_SQL = (
    "SELECT f.key AS key, count(*) AS c, sum(f.v) AS s "
    "FROM dim d JOIN fact f ON d.ikey = f.ikey GROUP BY f.key ORDER BY key"
)
CACHE_WARM = 2  # warm runs a setting, in turns


def oracle_flip(tables: dict) -> dict:
    """CACHE_FLIP_SQL in numpy: the fact's rows whose ikey the dimension
    holds, grouped by key (count, f64 sum), in key order."""
    import numpy as np

    key = tables["fact"].column("key").to_numpy()
    ikey = tables["fact"].column("ikey").to_numpy()
    v = tables["fact"].column("v").to_numpy()
    keep = ikey < tables["dim"].num_rows
    keys, inv = np.unique(key[keep], return_inverse=True)
    return {
        "key": keys,
        "c": np.bincount(inv, minlength=len(keys)).astype(np.int64),
        "s": np.bincount(inv, weights=v[keep], minlength=len(keys)),
    }


def cache_resident_bytes(ctx) -> int:
    """Device bytes that the build tables kept on ``ctx``'s plan instances
    hold, every tensor of them counted once by its storage: the tally's
    columns, and the null masks, valid masks and direct-address tables it
    does not count."""
    from ballista_tpu_torch.exec import joins

    seen: set = set()

    def tensors(b) -> list:
        return [*b.columns, *(m for m in b.nulls if m is not None), b.valid]

    def walk(p) -> int:
        total = 0
        for batch, bt in getattr(p, "_build_cache", {}).values() if isinstance(p, joins.HashJoinExec) else ():
            extra = [bt.keys, *bt.key_cols] + ([bt.lut2] if bt.lut2 is not None else [])
            for t in tensors(batch) + tensors(bt.batch) + extra:
                st = t.untyped_storage()
                if st.data_ptr() not in seen:
                    seen.add(st.data_ptr())
                    total += st.nbytes()
        return total + sum(walk(c) for c in p.children())

    return sum(walk(p) for p in ctx._physical_cache.values())


def build_cache_path(data: dict, earlier: dict, rec: "LaunchRecorder", prec: "PartitionRecorder") -> dict:
    """Phase 15: one ``TorchContext(device="cuda")`` over phase 5's tables
    and ``skewed_tables(AQE_FACT_ROWS, int_keys=True)``; each query of ``CACHE_QUERIES`` and
    ``CACHE_FLIP_SQL`` once cold (``build_cache_mb`` at its default, 2048),
    then ``CACHE_WARM`` warm runs at ``build_cache_mb`` 0 and at 2048 in
    turns (the setting swapped on the context between runs; its plan cache
    keys plan instances by the settings, so each setting runs its own).
    Every run is held against phases 5 and 6's card results (keys and
    counts exactly, floats within rtol 1e-9, the sort path's money sums bit
    for bit) or the flip's numpy oracle; all warm runs of a query bit for
    bit with each other; no warm run retries; at 2048 a warm run keeps no
    new table, at 0 no run keeps one; the flip fires on every warm run of
    CACHE_FLIP_SQL. Prints per query the warm seconds of both settings,
    the tables kept and skipped, the flips, the retries, and the peak device
    memory: of the turns at 2048, and of one more warm round at 0 after
    the 2048 plan instances (and their tables) were dropped."""
    import gc

    import torch

    from ballista_tpu_torch.config import BallistaConfig
    from ballista_tpu_torch.exec import joins
    from ballista_tpu_torch.exec.base import plan_counters
    from ballista_tpu_torch.exec.context import TorchContext
    from ballista_tpu_torch.ops import onehot_agg, partition, prefix_sum

    # the earlier phases' garbage (reference cycles holding device tensors)
    # goes first, so that the peaks below compare the two settings alone
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    flip = skewed_tables(AQE_FACT_ROWS, int_keys=True)
    flip_want = oracle_flip(flip)
    out: dict = {"tables_s": time.perf_counter() - t0}
    on, off = BallistaConfig(), BallistaConfig({"ballista.tpu.build_cache_mb": "0"})
    ctx = TorchContext(on, device="cuda")
    for name, t in {**data, **flip}.items():
        ctx.register_table(name, t)
    sqls = {q: earlier[q][0] for q in CACHE_QUERIES}
    sqls["flip"] = CACHE_FLIP_SQL
    launches = {"onehot": 0, "prefix": 0, "partition": 0, "grouped": 0}
    # learned flips taken (each probe partition enters the path once)
    flips = [0]
    real_flip = joins.HashJoinExec._execute_learned_flip

    def counted_flip(self, partition, *a, **kw):
        if partition == 0:
            flips[0] += 1
        return real_flip(self, partition, *a, **kw)

    def one_run(q: str, cfg) -> dict:
        ctx.config = cfg
        onehot_agg.launches = partition.launches = partition.group_launches = 0
        p0, f0 = prefix_sum.launches, flips[0]
        rec.tag = prec.tag = f"{q}-cache"
        torch.cuda.reset_peak_memory_stats()
        try:
            t = time.perf_counter()
            df = ctx.sql(sqls[q])
            res, plan = df.collect_with_plan()
            torch.cuda.synchronize()
            secs = time.perf_counter() - t
        finally:
            rec.tag = prec.tag = None
        r = dict(
            s=secs, table=res, peak=torch.cuda.max_memory_allocated(),
            retries=sum(df.stats.values()), flips=flips[0] - f0,
            **plan_counters(plan, ("build_cache_store", "build_cache_skip")),
            launches=onehot_agg.launches, plaunches=prefix_sum.launches - p0,
            hlaunches=partition.launches, glaunches=partition.group_launches,
        )
        launches["onehot"] += r["launches"]
        launches["prefix"] += r["plaunches"]
        launches["partition"] += r["hlaunches"]
        launches["grouped"] += r["glaunches"]
        if q == "flip":
            compare(f"flip-cache run ({'on' if cfg is on else 'off'})", res, flip_want)
        else:
            held_as(f"{q}-cache run ({'on' if cfg is on else 'off'})", q, res, earlier[q][1], exact=True)
        return r

    joins.HashJoinExec._execute_learned_flip = counted_flip
    try:
        for q in sqls:
            cold = one_run(q, on)
            turns = {"off": [], "on": []}
            for _ in range(CACHE_WARM):
                turns["off"].append(one_run(q, off))
                turns["on"].append(one_run(q, on))
            warm = turns["off"] + turns["on"]
            first = warm[0]["table"]
            for r in warm[1:]:
                check(r["table"].equals(first), f"{q}-cache: two warm runs differ")
            check(not any(r["retries"] for r in warm), f"{q}-cache: a warm run retried")
            check(all(r["build_cache_store"] == r["build_cache_skip"] == 0 for r in turns["off"]),
                  f"{q}-cache: a run at build_cache_mb 0 kept or offered a table")
            check(all(r["build_cache_store"] == 0 for r in turns["on"][1:]),
                  f"{q}-cache: a warm run at 2048 kept a new table")
            if q == "flip":
                check(cold["flips"] == 0 and all(r["flips"] == 1 for r in warm),
                      f"flip-cache: the learned flip fired {[r['flips'] for r in [cold] + warm]}")
            out[q] = dict(
                cold_s=cold["s"], cold_retries=cold["retries"],
                warm_off_s=[r["s"] for r in turns["off"]], warm_on_s=[r["s"] for r in turns["on"]],
                stores=[r["build_cache_store"] for r in [cold] + turns["on"]],
                skips=[r["build_cache_skip"] for r in [cold] + turns["on"]],
                flips=[r["flips"] for r in [cold] + warm],
                peak_on=max(r["peak"] for r in turns["on"]),
                peak_off_turns=max(r["peak"] for r in turns["off"]),
                onehot_launches=[r["launches"] for r in [cold] + warm],
                prefix_launches=[r["plaunches"] for r in [cold] + warm],
                partition_launches=[r["hlaunches"] for r in [cold] + warm],
            )
            log(f"{q}-cache: ok  {json.dumps(out[q])}")
        out["cache_bytes"] = ctx._plan_cache.get("__build_cache_bytes__", 0)
        out["cache_resident_bytes"] = cache_resident_bytes(ctx)
        out["allocated_with_tables_bytes"] = torch.cuda.memory_allocated()
        out["peak_on_bytes"] = max(out[q]["peak_on"] for q in sqls)
        out["peak_off_turns_bytes"] = max(out[q]["peak_off_turns"] for q in sqls)
        # without the cache: the 2048 instances go, and their tables with them
        for key in [k for k in ctx._physical_cache if not k[1]]:
            del ctx._physical_cache[key]
        ctx._plan_cache.pop("__build_cache_bytes__", None)
        gc.collect()
        torch.cuda.empty_cache()
        out["allocated_after_drop_bytes"] = torch.cuda.memory_allocated()
        out["peak_off_bytes"] = max(one_run(q, off)["peak"] for q in sqls)
    finally:
        joins.HashJoinExec._execute_learned_flip = real_flip
        ctx.config = on
    log(f"build cache: tables {out['cache_bytes']} bytes by the tally, {out['cache_resident_bytes']} "
        f"resident; peak device memory with the cache {out['peak_on_bytes']} bytes, without "
        f"{out['peak_off_bytes']} bytes; launches {json.dumps(launches)}")
    out.update(launches=launches["onehot"], prefix_launches=launches["prefix"],
               partition_launches=launches["partition"], grouped_launches=launches["grouped"])
    return out


# -- phase 16: the adaptive capacity machinery ---------------------------------

# TPC-H queries whose plans reach the capacity shrink or the clustered
# aggregate: q18's HAVING over lineitem grouped by l_orderkey (clustered:
# the disjoint path) and its SEMI join; q5's and q3's filtered builds and
# joins; q10's joins; q6's selective filter chain feeding a scalar
# aggregate; q13's LEFT join and its two aggregates
ADAPTIVE_QUERIES = ("q18", "q5", "q3", "q10", "q6", "q13")
ADAPTIVE_WARM = 2  # warm runs a query
ADAPTIVE_COUNTERS = (
    "input_batches", "boundary_trims", "disjoint_break", "final_disjoint_skip",
    "final_disjoint_miss",
)
ADAPTIVE_FAMILIES = ("shrink", "agg_sorted", "agg_state_cap", "agg_state_prefix")
# a float SUM that is not a decimal at any scale over lineitem grouped by
# its clustered l_orderkey: warm runs take the presorted arm, whose f64
# prefix reads the live rows moved to the front, as the cold run's sort
# path does (the same bits)
CLUSTERED_F64_SQL = (
    "SELECT l_orderkey, SUM(l_extendedprice / (l_quantity + 1)) AS s, COUNT(*) AS c "
    "FROM lineitem GROUP BY l_orderkey ORDER BY s DESC, l_orderkey LIMIT 20"
)
# the forced shrink staleness: a filter that keeps 0.1% of 4,194,304 rows
# learns a shrink, then keeps 30% of them under the learned capacity
GROWN_SQL = "SELECT COUNT(*) AS c, SUM(v) AS s FROM grown WHERE k < 1000"


def oracle_clustered_f64(li) -> dict:
    """CLUSTERED_F64_SQL in numpy."""
    import numpy as np

    ok = li.column("l_orderkey").to_numpy()
    x = li.column("l_extendedprice").to_numpy() / (li.column("l_quantity").to_numpy() + 1)
    keys, inv = np.unique(ok, return_inverse=True)
    s = np.bincount(inv, weights=x)
    top = np.lexsort((keys, -s))[:20]
    return {"l_orderkey": keys[top], "s": s[top], "c": np.bincount(inv)[top].astype(np.int64)}


def adaptive_entries(cache: dict) -> dict:
    return {k: v for k, v in cache.items() if isinstance(k, tuple) and k and k[0] in ADAPTIVE_FAMILIES}


def site_head(key: tuple) -> str:
    """A learned entry's site in one line: the first line of the plan
    display it names."""
    site = next((p for p in key[1:] if isinstance(p, str) and p), "")
    return site.split("\n")[0][:90]


def grown_table(live: int, seed: int):
    """4,194,304 rows, ``live`` of them with ``k < 1000``."""
    import numpy as np
    import pyarrow as pa

    rng = np.random.default_rng(seed)
    n = 1 << 22
    k = np.full(n, 1 << 20, dtype=np.int64)
    k[rng.choice(n, live, replace=False)] = rng.integers(0, 1000, live)
    return pa.table({"k": k, "v": rng.random(n)})


def shuffled_in_batches(table, partitions: int, batch_rows: int, seed: int):
    """``table`` with its rows shuffled within each batch that a memory scan
    of ``partitions`` partitions and ``batch_rows``-row batches reads
    (``exec/scan.MemoryScanExec``): every batch keeps its rows, so every
    partial state keeps its groups and every filter its live count, but no
    batch is clustered any more."""
    import numpy as np

    rng = np.random.default_rng(seed)
    n = table.num_rows
    per = -(-n // partitions)
    idx = np.arange(n)
    for p0 in range(0, n, per):
        for b0 in range(p0, min(p0 + per, n), batch_rows):
            b1 = min(b0 + batch_rows, p0 + per, n)
            idx[b0:b1] = rng.permutation(idx[b0:b1])
    return table.take(idx)


def adaptive_path(data: dict, earlier: dict, rec: "LaunchRecorder", prec: "PartitionRecorder") -> dict:
    """Phase 16: the adaptive capacity shrink and the aggregate's clustered
    paths on one ``TorchContext(device="cuda")`` over phase 5's tables at
    ``build_cache_mb`` 0 (a kept build table would skip the subtrees that
    shrink and aggregate). Each query of ``ADAPTIVE_QUERIES`` runs cold
    once and ``ADAPTIVE_WARM`` times warm, each run held against phases
    4-6's card results (keys and counts exactly, floats within rtol 1e-9,
    the money sums bit for bit); the warm runs bit for bit among
    themselves, with no retry and no miss. q18's lineitem aggregate must
    take the disjoint path (no break, a final disjoint skip) and q18 and q5
    must shrink at some site. ``CLUSTERED_F64_SQL`` runs the same way
    against its numpy oracle, its warm runs (the presorted arm) bit for bit
    with its cold run (the sort path). Then two forced stale cases, each one
    SpeculationMiss, one re-run and a right result: a filter whose input
    grew under its learned shrink capacity, and q18 over lineitem shuffled
    within each scan batch under its learned ``agg_sorted`` entries. Prints
    the shrink sites learned (site, partition, capacity -> capacity), the
    presorted and state-slice entries, q18's counters, each warm run's
    retries and misses, a warm run's host syncs and the phase's peak device
    memory. The kernels' launches are recorded (their inputs kept on the
    host) for the replays."""
    import gc

    import numpy as np
    import torch

    from ballista_tpu_torch.config import BallistaConfig
    from ballista_tpu_torch.exec.base import plan_counters
    from ballista_tpu_torch.exec.context import TorchContext
    from ballista_tpu_torch.ops import onehot_agg, partition, prefix_sum

    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    cfg = BallistaConfig({"ballista.tpu.build_cache_mb": "0"})
    ctx = TorchContext(cfg, device="cuda")
    for name in ("lineitem", "orders", "customer", "nation", "region", "supplier"):
        ctx.register_table(name, data[name])
    launches = {"onehot": 0, "prefix": 0, "partition": 0, "grouped": 0}
    out: dict = {}

    def one_run(tag: str, sql: str, syncs: bool = False) -> dict:
        onehot_agg.launches = partition.launches = partition.group_launches = 0
        p0 = prefix_sum.launches
        rec.tag = prec.tag = tag
        try:
            t = time.perf_counter()
            df = ctx.sql(sql)
            if syncs:
                (res, plan), n_syncs = count_syncs(df.collect_with_plan)
            else:
                res, plan = df.collect_with_plan()
                n_syncs = None
            torch.cuda.synchronize()
            secs = time.perf_counter() - t
        finally:
            rec.tag = prec.tag = None
        r = dict(s=secs, table=res, plan=plan, stats=dict(df.stats), syncs=n_syncs,
                 launches=onehot_agg.launches, plaunches=prefix_sum.launches - p0,
                 hlaunches=partition.launches, glaunches=partition.group_launches,
                 **plan_counters(plan, ADAPTIVE_COUNTERS))
        launches["onehot"] += r["launches"]
        launches["prefix"] += r["plaunches"]
        launches["partition"] += r["hlaunches"]
        launches["grouped"] += r["glaunches"]
        return r

    f64_want = oracle_clustered_f64(data["lineitem"])

    def held(tag: str, q: str, got, want) -> None:
        if q == "f64":
            compare(tag, got, f64_want)
        else:
            held_as(tag, q, got, want, exact=True)

    rec.keep = prec.keep = rec.keep_on_host = prec.keep_on_host = rec.keep_prefix = True
    try:
        for q in ADAPTIVE_QUERIES + ("f64",):
            sql, want = earlier[q] if q != "f64" else (CLUSTERED_F64_SQL, None)
            before = adaptive_entries(ctx._plan_cache)
            tag = f"{q}-adaptive"
            cold = one_run(tag, sql)
            held(f"{tag} cold", q, cold["table"], want)
            warm = []
            for i in range(ADAPTIVE_WARM):
                # the second warm run counts its host syncs (sync debug mode
                # slows it: its seconds are not kept)
                warm.append(one_run(tag, sql, syncs=i == 1))
                held(f"{tag} warm {i}", q, warm[-1]["table"], want)
            for r in warm[1:]:
                check(r["table"].equals(warm[0]["table"]), f"{tag}: two warm runs differ")
            if q == "f64":
                check(warm[0]["table"].equals(cold["table"]), f"{tag}: the presorted arm's bits differ from the sort path's")
            check(not any(r["stats"] for r in warm), f"{tag}: a warm run retried: {[r['stats'] for r in warm]}")
            learned = {k: v for k, v in adaptive_entries(ctx._plan_cache).items() if before.get(k) != v}
            shrinks = [
                dict(site=site_head(k), partition=k[2], capacity=k[3], to=v)
                for k, v in learned.items() if k[0] == "shrink"
            ]
            layouts = [
                dict(entry=k[0], site=site_head(k), key=[p for p in k[3:] if not isinstance(p, str)], value=v)
                for k, v in learned.items() if k[0] != "shrink"
            ]
            out[q] = dict(
                cold_s=cold["s"], cold_stats=cold["stats"],
                warm_s=[r["s"] for i, r in enumerate(warm) if i != 1],
                warm_stats=[r["stats"] for r in warm], warm_syncs=warm[1]["syncs"],
                shrinks=shrinks, shrunk=sum(1 for s in shrinks if s["to"]), layouts=layouts,
                counters={c: warm[0][c] for c in ADAPTIVE_COUNTERS},
                cold_counters={c: cold[c] for c in ADAPTIVE_COUNTERS},
                onehot_launches=[r["launches"] for r in [cold] + warm],
                prefix_launches=[r["plaunches"] for r in [cold] + warm],
                partition_launches=[r["hlaunches"] for r in [cold] + warm],
            )
            log(f"{tag}: ok  {json.dumps(out[q])}")
        check(out["f64"]["prefix_launches"][-1] > 0, "f64-adaptive: a warm run launched no prefix sum")
        q18 = out["q18"]
        check(q18["counters"]["disjoint_break"] == 0 and q18["counters"]["final_disjoint_skip"] >= 1,
              f"q18-adaptive: the lineitem aggregate left the disjoint path: {q18['counters']}")
        check(any(e["entry"] == "agg_sorted" and e["value"] is True for e in q18["layouts"]),
              "q18-adaptive: no clustered-input entry learned")
        for q in ("q18", "q5"):
            check(out[q]["shrunk"] > 0, f"{q}-adaptive: no site shrank")

        # (a) a grown input under a learned shrink capacity. Registering a
        # table clears the plan cache: what was learned is put back, as a
        # hint file would seed a new process
        learned = {k: v for k, v in ctx._plan_cache.items() if k != "__build_cache_bytes__"}
        ctx.register_table("grown", grown_table(4194, seed=31))
        ctx._plan_cache.update(learned)
        learn = one_run("grown-adaptive", GROWN_SQL)
        kept = {k: v for k, v in ctx._plan_cache.items() if k != "__build_cache_bytes__"}
        check(any(k[0] == "shrink" and v and k[1].startswith("FilterExec: k < 1000") for k, v in adaptive_entries(kept).items()),
              "grown: the filter learned no shrink")
        big = grown_table(1_258_291, seed=32)
        ctx.register_table("grown", big)
        ctx._plan_cache.update(kept)
        stale = one_run("grown-adaptive", GROWN_SQL)
        kv, vv = big.column("k").to_numpy(), big.column("v").to_numpy()
        compare("grown-adaptive", stale["table"], {"c": np.array([int((kv < 1000).sum())]),
                                                   "s": np.array([vv[kv < 1000].sum()])})
        check(stale["stats"] == {"speculation_misses": 1},
              f"grown-adaptive: {stale['stats']}, expected exactly one speculation miss")
        out["grown"] = dict(learn_s=learn["s"], stale_s=stale["s"], stale_stats=stale["stats"])
        log(f"grown-adaptive: ok  {json.dumps(out['grown'])}")

        # (b) lineitem shuffled within its scan batches under learned
        # clustered-input entries
        sql, want = earlier["q18"]
        kept = {k: v for k, v in ctx._plan_cache.items() if k != "__build_cache_bytes__"}
        ts = time.perf_counter()
        shuffled = shuffled_in_batches(data["lineitem"], cfg.default_shuffle_partitions(), cfg.tpu_batch_rows(), seed=33)
        shuffle_s = time.perf_counter() - ts
        ctx.register_table("lineitem", shuffled)
        ctx._plan_cache.update(kept)
        stale = one_run("q18-shuffled-adaptive", sql)
        held_as("q18-shuffled-adaptive", "q18", stale["table"], want, exact=True)
        check(stale["stats"] == {"speculation_misses": 1},
              f"q18-shuffled-adaptive: {stale['stats']}, expected exactly one speculation miss")
        flipped = [k for k, v in kept.items() if k[0] == "agg_sorted" and v is True
                   and ctx._plan_cache.get(k) is not True]
        check(bool(flipped), "q18-shuffled-adaptive: no clustered-input entry was dropped")
        out["shuffled"] = dict(shuffle_s=shuffle_s, stale_s=stale["s"], stale_stats=stale["stats"],
                               dropped=[site_head(k) for k in flipped],
                               counters={c: stale[c] for c in ADAPTIVE_COUNTERS})
        log(f"q18-shuffled-adaptive: ok  {json.dumps(out['shuffled'])}")
    finally:
        rec.tag = prec.tag = None
        rec.keep = prec.keep = rec.keep_on_host = prec.keep_on_host = rec.keep_prefix = False
    out["peak_bytes"] = torch.cuda.max_memory_allocated()
    out["s"] = time.perf_counter() - t0
    log(f"adaptive: peak device memory {out['peak_bytes']} bytes ({out['peak_bytes'] / 2**30:.3f} GiB), "
        f"launches {json.dumps(launches)}, {out['s']:.1f}s")
    out.update(launches=launches["onehot"], prefix_launches=launches["prefix"],
               partition_launches=launches["partition"], grouped_launches=launches["grouped"])
    return out


# -- phase 17: the static-analysis gate and the durability witness ---------

GATE_ANALYZERS = (
    "planlint", "serde-audit", "devlint", "racelint", "compile-vocab", "lifelint",
    "proto-drift", "config-registry", "eqlint", "detlint", "stalelint", "durlint",
)
DURABLE_QUERIES = ("q1", "q3")


def start_gate(pkg_root: pathlib.Path, device: str = "cuda"):
    """Start (a) of phase 17, ``python -m ballista_tpu_torch.analysis
    --json`` of ``pkg_root``, as a child process (the full 22-query corpus;
    ``device`` is the default one unless asked otherwise). It runs on the
    host's CPU beside (b). Returns (process, start time) for
    ``finish_gate``."""
    cmd = [sys.executable, "-m", "ballista_tpu_torch.analysis", "--json"]
    if device != "cuda":
        cmd += ["--device", device]
    proc = subprocess.Popen(
        cmd, cwd=pkg_root, env=child_env("off"), stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True,
    )
    return proc, time.perf_counter()


def finish_gate(started) -> dict:
    """(a) of phase 17: every analyzer green, the suppression ledger
    within budget; prints each analyzer's seconds and the gate's wall
    seconds."""
    proc, t = started
    try:
        stdout, stderr = proc.communicate(timeout=300)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    wall = time.perf_counter() - t
    check(proc.returncode == 0, f"analysis gate: exit {proc.returncode}\n{stdout[-4000:]}\n"
          f"{stderr[-4000:]}")
    doc = json.loads(stdout)
    names = [a["name"] for a in doc["analyzers"]]
    check(names == list(GATE_ANALYZERS), f"analysis gate: analyzers {names}")
    check(doc["ok"] and all(a["ok"] for a in doc["analyzers"]), f"analysis gate: {doc['failed']}")
    check(all(r["used"] <= r["budget"] for r in doc["suppressions"].values()),
          f"analysis gate: suppressions over budget {doc['suppressions']}")
    out = dict(
        wall_s=wall,
        seconds={a["name"]: a["seconds"] for a in doc["analyzers"]},
        suppressions={k: r["used"] for k, r in doc["suppressions"].items()},
        summaries={a["name"]: a["summary"] for a in doc["analyzers"]},
    )
    log(f"analysis gate: all {len(names)} analyzers green in {wall:.1f}s (wall, beside the restart); "
        f"seconds {json.dumps(out['seconds'])}; suppressions {json.dumps(out['suppressions'])}")
    return out


def witness_checks(metrics_text: str) -> dict:
    """``ballista_dur_witness_checks_total`` of a Prometheus scrape, summed
    by outcome."""
    import re

    out: dict = {}
    for line in metrics_text.splitlines():
        m = re.match(r'ballista_dur_witness_checks_total\{field="[^"]*",outcome="([^"]*)"\} (\S+)$', line)
        if m:
            out[m.group(1)] = out.get(m.group(1), 0) + float(m.group(2))
    return out


def durability_path(data: dict, oracles: dict, rec: "LaunchRecorder", prec: "PartitionRecorder",
                    device: str = "cuda") -> dict:
    """(b) of phase 17: the durability witness across a real restart. The
    port's scheduler on a ``SqliteBackend`` in a temp directory, with
    ``BALLISTA_DUR_WITNESS=1`` in this process, one executor on
    ``device`` (pull-staged, K = 4) and the REST server; q1 and q3 held
    against the numpy oracles; ``durwitness.snapshot``; the scheduler
    stopped and a new one started on the same sqlite file and gRPC port;
    once the executor has re-registered, ``verify_restart`` and
    ``assert_no_divergence`` (checks above zero); q1 once more on the
    restarted cluster against its oracle; then the
    ``ballista_dur_witness_checks_total`` family scraped from the new
    scheduler's ``/api/metrics``, its checks by outcome printed. Every
    count is set to 0 just before the queries and read just after."""
    import os
    import shutil
    import tempfile
    import urllib.request

    from ballista_tpu_torch.analysis import durreg, durwitness
    from ballista_tpu_torch.client.context import BallistaContext
    from ballista_tpu_torch.config import BallistaConfig
    from ballista_tpu_torch.ops import onehot_agg, partition, prefix_sum
    from ballista_tpu_torch.scheduler.rest import start_rest_server, stop_rest_server
    from ballista_tpu_torch.scheduler.server import SchedulerServer, start_scheduler_grpc
    from ballista_tpu_torch.scheduler.state_backend import SqliteBackend
    from ballista_tpu_torch.standalone import StandaloneCluster

    t0 = time.perf_counter()
    sqls = {q: (ROOT / "benchmarks" / "queries" / f"{q}.sql").read_text() for q in DURABLE_QUERIES}
    tmp = pathlib.Path(tempfile.mkdtemp(prefix="chip-smoke-durable-"))
    path = str(tmp / "scheduler.db")
    env0 = os.environ.get("BALLISTA_DUR_WITNESS")
    os.environ["BALLISTA_DUR_WITNESS"] = "1"
    durwitness.enable()
    durwitness.reset()
    cfg = BallistaConfig(CLUSTER_SETTINGS)
    cluster = StandaloneCluster.start(
        cfg, 2, state_backend=SqliteBackend(path), n_executors=1, device=device
    )
    ctx = BallistaContext(f"localhost:{cluster.scheduler_port}", cfg, device=device)
    ctx._standalone_cluster = cluster
    cluster.attach_provider(ctx)
    rest = None
    launches = {"onehot": 0, "prefix": 0, "partition": 0, "grouped": 0}
    out: dict = {"runs": {}}

    def one_run(tag: str, q: str) -> None:
        onehot_agg.launches = partition.launches = partition.group_launches = 0
        p0 = prefix_sum.launches
        rec.tag = prec.tag = tag
        try:
            t = time.perf_counter()
            res = ctx.sql(sqls[q]).collect()
            secs = time.perf_counter() - t
        finally:
            rec.tag = prec.tag = None
        run = dict(s=secs, onehot=onehot_agg.launches, partition=partition.launches,
                   grouped=partition.group_launches, prefix=prefix_sum.launches - p0)
        for k in launches:
            launches[k] += run[k]
        compare(tag, res, oracles[q])
        out["runs"][tag] = run
        log(f"{tag}: ok  {json.dumps(run)}")

    try:
        for name, tab in data.items():
            ctx.register_table(name, tab)
        for q in DURABLE_QUERIES:
            one_run(f"{q}-durable", q)
        sched = cluster.scheduler
        (eid,) = [h.executor.executor_id for h in cluster.executors]
        before = durwitness.snapshot(sched)
        check(bool(before["job-record"]) and all(s == "completed" for s, _, _ in before["job-record"].values()),
              f"durable: jobs before the restart {before['job-record']}")

        # the scheduler stops (its executor does not) and starts again on
        # the same sqlite file and gRPC port
        t = time.perf_counter()
        sched.shutdown()
        ev = cluster.scheduler_grpc.stop(grace=None)
        if ev is not None:
            ev.wait(timeout=5)
        restarted = SchedulerServer(provider=ctx, config=cfg, state_backend=SqliteBackend(path))
        grpc_server, port = start_scheduler_grpc(restarted, "127.0.0.1", cluster.scheduler_port)
        check(port == cluster.scheduler_port, f"durable: restarted on port {port}, not {cluster.scheduler_port}")
        cluster.scheduler, cluster.scheduler_grpc = restarted, grpc_server
        rest, rest_port = start_rest_server(restarted, "127.0.0.1", 0)
        deadline = time.monotonic() + 30
        while time.monotonic() < deadline and (
            restarted.executor_manager.last_seen(eid) is None
            or restarted.executor_manager.get_executor_data(eid) is None
        ):
            time.sleep(0.05)
        check(restarted.executor_manager.last_seen(eid) is not None,
              "durable: the executor did not re-register within 30 s")
        out["reregister_s"] = time.perf_counter() - t
        outcomes = durwitness.verify_restart(before, restarted, reregistered=(eid,))
        durwitness.assert_no_divergence()
        checks = durwitness.counters()
        check(sum(checks.values()) > 0 and set(outcomes) == {e.name for e in durreg.STATE},
              f"durable: witness checks {checks}")
        out["outcomes"] = outcomes
        out["witness"] = durwitness.summary()
        log(f"durable: restart verified, executor re-registered in {out['reregister_s']:.2f}s; "
            f"{out['witness']}")

        one_run("q1-restarted", "q1")
        with urllib.request.urlopen(f"http://127.0.0.1:{rest_port}/api/metrics", timeout=10) as r:
            scraped = witness_checks(r.read().decode())
        check(scraped.get("match", 0) > 0 and scraped.get("divergent", 0) == 0,
              f"durable: scraped ballista_dur_witness_checks_total {scraped}")
        out["scraped_checks"] = scraped
        log(f"durable: ballista_dur_witness_checks_total by outcome {json.dumps(scraped)}")
        check(launches["onehot"] > 0 and launches["grouped"] > 0 and launches["prefix"] > 0,
              f"durable: the queries did not launch every kernel {launches}")
    finally:
        if rest is not None:
            stop_rest_server(rest)
        ctx.close()
        durwitness.enable(False)
        durwitness.reset()
        if env0 is None:
            os.environ.pop("BALLISTA_DUR_WITNESS", None)
        else:
            os.environ["BALLISTA_DUR_WITNESS"] = env0
        shutil.rmtree(tmp, ignore_errors=True)
    out["s"] = time.perf_counter() - t0
    out.update(launches=launches["onehot"], prefix_launches=launches["prefix"],
               partition_launches=launches["partition"], grouped_launches=launches["grouped"])
    log(f"durable: launches {json.dumps(launches)}, {out['s']:.1f}s")
    return out


def analysis_only(pkg_root: pathlib.Path, sf: float, seed: int) -> dict:
    """``--analysis-only``: phase 17 alone, on TPC-H at ``sf`` with the
    oracles of q1 and q3 computed here."""
    from ballista_tpu_torch.tpch import gen_all

    data = gen_all(sf, seed)
    oracles = {"q1": oracle_q1(lineitem_columns(data["lineitem"])), "q3": oracle_q3(host_columns(data))}
    with LaunchRecorder() as rec, PartitionRecorder() as prec:
        t0 = time.perf_counter()
        gate = start_gate(pkg_root)
        try:
            out = {"durable": durability_path(data, oracles, rec, prec)}
        finally:
            out_gate = finish_gate(gate)
        out["gate"] = out_gate
        out["phase_s"] = time.perf_counter() - t0
    return out


# -- phase 18: prewarm, the executor's background prewarm, profile_dir, trace --

HOOKS_QUERIES = ("q1", "q6")
HOOKS_BUDGET_MB = GRACE_BUDGET_MB

# (a)'s child: a context on the card with ``ballista.tpu.prewarm`` set to
# argv[2] (the default ladder up to ``tpu_batch_rows()``), lineitem read
# from the parent's Arrow IPC file, q1 and q6 cold; their results written
# back as Arrow IPC for the parent to hold against its oracles, and one
# JSON line of seconds, counters, the prewarm's own kernel launches (read
# before any query) and peak device memory
PREWARM_CHILD = r"""
import json
import sys
import time

root, mode, tables, out_dir = sys.argv[1:5]
sys.path.insert(0, root)
import pyarrow as pa
import pyarrow.ipc as ipc
import torch

from ballista_tpu_torch.compilecache import metrics
from ballista_tpu_torch.config import BallistaConfig
from ballista_tpu_torch.exec.context import TorchContext
from ballista_tpu_torch.ops import onehot_agg, partition, prefix_sum

torch.zeros(1, device="cuda")  # the card's context, before any timer
t = time.perf_counter()
ctx = TorchContext(BallistaConfig({"ballista.tpu.prewarm": mode}), device="cuda")
torch.cuda.synchronize()
out = {"mode": mode, "prewarm_s": time.perf_counter() - t, "n_signatures": ctx._prewarm.n_signatures}
out["prewarm_launches"] = dict(
    onehot=onehot_agg.launches, partition=partition.launches,
    grouped=partition.group_launches, prefix=prefix_sum.launches,
)
ctx.register_table("lineitem", ipc.open_file(pa.memory_map(tables + "/lineitem.arrow")).read_all())
for q in ("q1", "q6"):
    sql = open(f"{root}/benchmarks/queries/{q}.sql").read()
    t = time.perf_counter()
    res = ctx.sql(sql).collect()
    out[q + "_cold_s"] = time.perf_counter() - t
    with ipc.new_file(f"{out_dir}/{mode}-{q}.arrow", res.schema) as w:
        w.write_table(res)
out["metrics"] = metrics.snapshot()
out["peak_bytes"] = torch.cuda.max_memory_allocated()
print(json.dumps(out))
"""


def prewarm_children(pkg_root: pathlib.Path, lineitem, oracles: dict, tmp: pathlib.Path) -> dict:
    """(a) of phase 18: two child processes on the card (the kernels built
    already), one with prewarm ``off`` and one with ``on`` at the default
    ladder; in both, q1 and q6 cold over lineitem against the numpy
    oracles. The ``on`` child runs every signature it enumerated, none
    failing. Prints the prewarm's seconds and count, each child's cold
    seconds and peak device memory."""
    import pyarrow as pa
    import pyarrow.ipc as ipc

    with ipc.new_file(str(tmp / "lineitem.arrow"), lineitem.schema) as w:
        w.write_table(lineitem)
    out: dict = {}
    for mode in ("off", "on"):
        t = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, "-c", PREWARM_CHILD, str(pkg_root), mode, str(tmp), str(tmp)],
            env=child_env("off"), capture_output=True, text=True, timeout=300,
        )
        check(proc.returncode == 0, f"prewarm child ({mode}): exit {proc.returncode}\n{proc.stderr[-4000:]}")
        res = json.loads(proc.stdout.strip().splitlines()[-1])
        res["child_s"] = time.perf_counter() - t
        for q in HOOKS_QUERIES:
            got = ipc.open_file(pa.memory_map(str(tmp / f"{mode}-{q}.arrow"))).read_all()
            compare(f"{q}-prewarm-{mode}", got, oracles[q])
        m = res["metrics"]
        if mode == "on":
            check(res["n_signatures"] > 0 and m.get("prewarmed_signatures") == res["n_signatures"],
                  f"prewarm on: {m.get('prewarmed_signatures')} signatures run of {res['n_signatures']}")
            check(m.get("prewarm_failures", 0) == 0, f"prewarm on: {m.get('prewarm_failures')} signatures failed")
        else:
            check(res["n_signatures"] == 0 and "prewarmed_signatures" not in m, f"prewarm off ran signatures: {m}")
        out[mode] = res
        log(f"prewarm {mode}: {res['n_signatures']} signatures in {res['prewarm_s']:.2f}s, launching "
            f"{json.dumps(res['prewarm_launches'])}; cold q1 {res['q1_cold_s']:.3f}s, q6 "
            f"{res['q6_cold_s']:.3f}s; peak device memory {res['peak_bytes']} bytes; the child "
            f"{res['child_s']:.1f}s")
    return out


def hooks_path(pkg_root: pathlib.Path, data: dict, oracles: dict, collected_q1) -> dict:
    """Phase 18: (a) ``prewarm_children``; (b) one executor started with
    ``--prewarm background`` (``BALLISTA_TPU_PREWARM``) on the port's
    scheduler, q1 while its prewarm runs, held against collect mode and
    the oracle and bit for bit against q1 again once the prewarm is done;
    after the cluster stops, no ``compile-prewarm`` thread is alive; (c)
    q1 on the collect context with ``ballista.tpu.profile_dir``: every
    attempt's trace is written and holds the one-hot kernel's launch, the
    traced warm run's seconds beside an untraced one's; (d) EXPLAIN
    ANALYZE of q3 under phase 7's device budget with ``ballista.tpu.trace``
    a JSONL path: one ``explain_analyze`` span and at least one
    ``spill_pass`` event with bytes. The launch counts are set to 0 once
    (b)'s prewarm is done, just before the q1 after it, and read after
    (d): they count queries only. The prewarm's own launches are (a)'s
    child's, read before its first query; (b)'s counts at the prewarm's
    end (its launches and those of the q1 beside it) are kept apart."""
    import os
    import shutil
    import tempfile
    import threading

    import torch

    from ballista_tpu_torch.client.context import BallistaContext
    from ballista_tpu_torch.compilecache import metrics
    from ballista_tpu_torch.config import BallistaConfig
    from ballista_tpu_torch.exec.context import TorchContext
    from ballista_tpu_torch.obs import trace as obs_trace
    from ballista_tpu_torch.ops import onehot_agg, partition, prefix_sum
    from ballista_tpu_torch.standalone import StandaloneCluster

    sqls = {q: (ROOT / "benchmarks" / "queries" / f"{q}.sql").read_text() for q in ("q1", "q3")}
    tmp = pathlib.Path(tempfile.mkdtemp(prefix="chip-smoke-hooks-"))
    out: dict = {}
    try:
        t0 = time.perf_counter()
        out["prewarm"] = prewarm_children(pkg_root, data["lineitem"], oracles, tmp)
        out["children_s"] = time.perf_counter() - t0

        onehot_agg.launches = partition.launches = partition.group_launches = 0
        p0 = prefix_sum.launches
        torch.cuda.reset_peak_memory_stats()

        # (b) the executor's background prewarm beside q1
        t = time.perf_counter()
        cfg = BallistaConfig(CLUSTER_SETTINGS)
        env0 = os.environ.get("BALLISTA_TPU_PREWARM")
        os.environ["BALLISTA_TPU_PREWARM"] = "background"
        try:
            cluster = StandaloneCluster.start(cfg, 2, n_executors=1, device="cuda")
        finally:
            if env0 is None:
                os.environ.pop("BALLISTA_TPU_PREWARM", None)
            else:
                os.environ["BALLISTA_TPU_PREWARM"] = env0
        ctx = BallistaContext(f"localhost:{cluster.scheduler_port}", cfg, device="cuda")
        ctx._standalone_cluster = cluster
        cluster.attach_provider(ctx)
        try:
            handle = cluster.executors[0].loop._prewarm
            check(handle is not None and handle.n_signatures > 0, "background prewarm: not started")
            ctx.register_table("lineitem", data["lineitem"])
            done0 = metrics.snapshot().get("prewarmed_signatures", 0)
            t1 = time.perf_counter()
            during = ctx.sql(sqls["q1"]).collect()
            q1_s = time.perf_counter() - t1
            done1 = metrics.snapshot().get("prewarmed_signatures", 0)
            check(handle.join(timeout=300), "background prewarm: not done within 300 s")
            beside = dict(onehot=onehot_agg.launches, partition=partition.launches,
                          grouped=partition.group_launches, prefix=prefix_sum.launches - p0)
            # from here on the counts are the queries' own: the prewarm's
            # are (a)'s child's
            onehot_agg.launches = partition.launches = partition.group_launches = 0
            p0 = prefix_sum.launches
            after = ctx.sql(sqls["q1"]).collect()
        finally:
            ctx.close()
        compare("q1-background-prewarm", during, oracles["q1"])
        compare_tables("q1-background-prewarm", during, collected_q1)
        check(during.equals(after), "q1 during the background prewarm: not bit for bit q1 after it")
        alive = [th.name for th in threading.enumerate() if th.name.startswith("compile-prewarm") and th.is_alive()]
        check(not alive, f"background prewarm: threads alive after stop {alive}")
        m = metrics.snapshot()
        check(m.get("prewarm_failures", 0) == 0, f"background prewarm: {m.get('prewarm_failures')} failures")
        out["background"] = dict(
            n_signatures=handle.n_signatures, done_at_q1_start=done0, done_at_q1_end=done1,
            q1_s=q1_s, prewarm_and_q1_launches=beside, s=time.perf_counter() - t,
        )
        log(f"background prewarm: {handle.n_signatures} signatures, {done0} done when q1 started and "
            f"{done1} when it ended ({q1_s:.3f}s); launches of the prewarm and that q1 {json.dumps(beside)}; "
            f"q1 bit for bit the run after; no compile-prewarm thread after stop; "
            f"{out['background']['s']:.1f}s")

        # (c) profile_dir: each attempt's torch.profiler trace
        t = time.perf_counter()
        prof = tmp / "profile"
        runs: dict = {}
        for tag, settings in (("untraced", {}), ("traced", {"ballista.tpu.profile_dir": str(prof)})):
            c = TorchContext(BallistaConfig(settings), device="cuda")
            c.register_table("lineitem", data["lineitem"])
            for run in ("cold", "warm"):
                t1 = time.perf_counter()
                res = c.sql(sqls["q1"]).collect()
                runs[f"{tag}_{run}_s"] = time.perf_counter() - t1
                compare(f"q1-{tag}-{run}", res, oracles["q1"])
        traces = sorted(prof.glob("*.pt.trace.json"), key=lambda p: p.stat().st_mtime)
        check(len(traces) >= 2, f"profile_dir: {len(traces)} traces for two runs")
        for p in traces[-1:]:
            events = json.loads(p.read_text())["traceEvents"]
            kernels = [e["name"] for e in events if str(e.get("cat", "")).lower() == "kernel"]
            check(any(n in k for k in kernels for n in ONEHOT_KERNELS),
                  f"profile_dir: no one-hot kernel among {len(kernels)} kernels of {p.name}")
            runs["kernels_in_warm_trace"] = len(kernels)
        runs["traces"] = len(traces)
        runs["trace_bytes"] = sum(p.stat().st_size for p in traces)
        runs["s"] = time.perf_counter() - t
        out["profile"] = runs
        log(f"profile_dir: q1 traced warm {runs['traced_warm_s']:.4f}s, untraced warm "
            f"{runs['untraced_warm_s']:.4f}s (cold {runs['traced_cold_s']:.3f}s, {runs['untraced_cold_s']:.3f}s); "
            f"{len(traces)} traces, {runs['trace_bytes']} bytes, the warm one with "
            f"{runs['kernels_in_warm_trace']} kernels, the one-hot kernel among them")

        # (d) trace: EXPLAIN ANALYZE of q3 under the budget, spans to JSONL
        t = time.perf_counter()
        path = tmp / "trace.jsonl"
        c = TorchContext(BallistaConfig({"ballista.tpu.hbm_budget_mb": str(HOOKS_BUDGET_MB),
                                         "ballista.tpu.trace": str(path)}), device="cuda")
        for name in ("customer", "orders", "lineitem"):
            c.register_table(name, data[name])
        try:
            t1 = time.perf_counter()
            c.sql("EXPLAIN ANALYZE " + sqls["q3"]).collect()
            analyze_s = time.perf_counter() - t1
        finally:
            obs_trace.configure("off")
        lines = [json.loads(ln) for ln in path.read_text().splitlines()]
        roots = [ln for ln in lines if ln["name"] == "explain_analyze"]
        passes = [ln for ln in lines if ln["name"] == "spill_pass"]
        check(len(roots) == 1, f"trace: {len(roots)} explain_analyze spans")
        check(passes and all(int(p["attrs"]["bytes"]) > 0 for p in passes), f"trace: spill_pass events {passes}")
        check(all(ln["trace_id"] == roots[0]["trace_id"] for ln in lines), "trace: spans of another trace")
        out["trace"] = dict(
            analyze_s=analyze_s, spans=len(lines), spill_passes=len(passes),
            spill_bytes=sum(int(p["attrs"]["bytes"]) for p in passes),
            names=sorted({ln["name"] for ln in lines}), s=time.perf_counter() - t,
        )
        log(f"trace: EXPLAIN ANALYZE q3 at {HOOKS_BUDGET_MB} MB in {analyze_s:.2f}s; {json.dumps(out['trace'])}")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    out["peak_bytes"] = torch.cuda.max_memory_allocated()
    out.update(launches=onehot_agg.launches, partition_launches=partition.launches,
               grouped_launches=partition.group_launches, prefix_launches=prefix_sum.launches - p0)
    check(out["launches"] > 0, "phase 18: no one-hot launch")
    log(f"hooks: launches onehot {out['launches']}, partition {out['partition_launches']}, grouped "
        f"{out['grouped_launches']}, prefix {out['prefix_launches']}; peak device memory {out['peak_bytes']} bytes")
    return out


def hooks_only(pkg_root: pathlib.Path, sf: float, seed: int) -> dict:
    """``--hooks-only``: phase 18 alone, on TPC-H at ``sf`` with the
    oracles of q1 and q6 and collect mode's q1 computed here."""
    from ballista_tpu_torch.exec.context import TorchContext
    from ballista_tpu_torch.tpch import gen_all

    data = gen_all(sf, seed)
    cols = lineitem_columns(data["lineitem"])
    oracles = {"q1": oracle_q1(cols), "q6": oracle_q6(cols)}
    c = TorchContext(device="cuda")
    c.register_table("lineitem", data["lineitem"])
    collected_q1 = c.sql((ROOT / "benchmarks" / "queries" / "q1.sql").read_text()).collect()
    t0 = time.perf_counter()
    out = hooks_path(pkg_root, data, oracles, collected_q1)
    out["phase_s"] = time.perf_counter() - t0
    return out


def adaptive_timing(root: pathlib.Path, sf: float, seed: int, warm: int) -> dict:
    """Seconds of phase 16's queries for one checkout (``root``'s
    ``benchmarks/queries``, spec constants replaced from the data): on one
    ``TorchContext(device="cuda")``, each query cold at ``build_cache_mb``
    0, then ``warm`` warm runs at 0 and ``warm`` at 2048 in turns (the
    setting swapped on the context between runs, as phase 15 does), with
    each run's retries and misses."""
    import torch

    from ballista_tpu_torch.config import BallistaConfig
    from ballista_tpu_torch.exec.context import TorchContext
    from ballista_tpu_torch.tpch import gen_all, spec_substitutions

    data = gen_all(sf, seed)
    off, on = BallistaConfig({"ballista.tpu.build_cache_mb": "0"}), BallistaConfig()
    ctx = TorchContext(off, device="cuda")
    for name, t in data.items():
        ctx.register_table(name, t)
    out = {}
    for q in ADAPTIVE_QUERIES:
        sql = (root / "benchmarks" / "queries" / f"{q}.sql").read_text()
        for old, new in spec_substitutions(q, data).items():
            sql = sql.replace(old, new)

        def run(cfg) -> tuple:
            ctx.config = cfg
            t = time.perf_counter()
            df = ctx.sql(sql)
            df.collect()
            torch.cuda.synchronize()
            return time.perf_counter() - t, sum(df.stats.values())

        cold = run(off)
        turns: dict = {"off": [], "on": []}
        for _ in range(warm):
            turns["off"].append(run(off))
            turns["on"].append(run(on))
        out[q] = dict(cold_s=cold[0], cold_retries=cold[1],
                      warm_off_s=[s for s, _ in turns["off"]], warm_on_s=[s for s, _ in turns["on"]],
                      warm_retries=[r for s, r in turns["off"] + turns["on"]])
        log(f"{q}: {json.dumps(out[q])}")
    ctx.config = off
    return out


def aqe_only(sf: float, seed: int) -> dict:
    """``--aqe-only``: phase 13 alone, on TPC-H at ``sf``, the five cluster
    queries held against one ``TorchContext(device="cuda")`` collect each
    and the numpy oracles; then the launches replayed."""
    from ballista_tpu_torch.exec.context import TorchContext
    from ballista_tpu_torch.tpch import gen_all

    data = gen_all(sf, seed)
    h = host_columns(data)
    oracles = {
        "q1": oracle_q1(lineitem_columns(data["lineitem"])),
        "q3": oracle_q3(h), "q5": oracle_q5(h), "q18": oracle_q18(h),
    }
    ctx = TorchContext(device="cuda")
    for name, t in data.items():
        ctx.register_table(name, t)
    collected = {
        q: ctx.sql((ROOT / "benchmarks" / "queries" / f"{q}.sql").read_text()).collect()
        for q in CLUSTER_QUERIES
    }
    del ctx
    with LaunchRecorder() as rec, PartitionRecorder() as prec:
        t0 = time.perf_counter()
        out = aqe_path(data, oracles, collected, rec, prec)
        out["replays"] = replay_launches(rec) + replay_partition_launches(prec)
        out["phase_s"] = time.perf_counter() - t0
    return out


def prefix_queries(sf: float, seed: int, warm: int) -> dict:
    """``--prefix-queries``: the two queries whose f64 SUMs take the
    prefix-sum kernel, each one cold and ``warm`` warm runs with its
    seconds and prefix-sum launches, the warm runs bit for bit: phase 14's
    sort-path plugin query on ``TorchContext(device="cuda")`` over TPC-H
    lineitem at ``sf``, and phase 13 (a)'s wrong-side build with AQE off
    on the port's cluster (two executors on the card). Uses only what the
    port had before the kernel's redesign, so that ``--root`` can time an
    earlier checkout's kernel on the same card."""
    import shutil
    import tempfile

    import torch

    from ballista_tpu_torch.client.context import BallistaContext
    from ballista_tpu_torch.config import BallistaConfig
    from ballista_tpu_torch.exec.context import TorchContext
    from ballista_tpu_torch.ops import prefix_sum
    from ballista_tpu_torch.tpch import gen_all

    out: dict = {}

    def timed(tag: str, run) -> None:
        runs = []
        for _ in range(1 + warm):
            p0 = prefix_sum.launches
            t = time.perf_counter()
            table = run()
            torch.cuda.synchronize()
            runs.append((time.perf_counter() - t, prefix_sum.launches - p0, table))
        check(all(r[2].equals(runs[1][2]) for r in runs[2:]), f"{tag}: the warm runs differ")
        check(runs[1][1] > 0, f"{tag}: no prefix-sum launch")
        out[tag] = dict(cold_s=runs[0][0], warm_s=[r[0] for r in runs[1:]], launches=runs[1][1])
        log(f"{tag}: ok  {json.dumps(out[tag])}")

    lineitem = gen_all(sf, seed)["lineitem"]
    plugin_dir = tempfile.mkdtemp(prefix="chip_smoke_plugins-")
    try:
        (pathlib.Path(plugin_dir) / "smoke_fns.py").write_text(PLUGIN_SOURCE)
        ctx = TorchContext(BallistaConfig({"ballista.plugin_dir": plugin_dir}), device="cuda")
        ctx.register_table("lineitem", lineitem)
        timed("plugin-sort", lambda: ctx.sql(PLUGIN_SORT_SQL).collect())
    finally:
        shutil.rmtree(plugin_dir, ignore_errors=True)
    cl = BallistaContext.standalone(
        BallistaConfig(AQE_OFF_SETTINGS), device="cuda", n_executors=2, concurrent_tasks=2
    )
    try:
        for name, tab in skewed_tables(AQE_FACT_ROWS).items():
            cl.register_table(name, tab)
        timed("wrong-build-off", lambda: cl.sql(WRONG_BUILD_SQL).collect())
    finally:
        cl.close()
    return out


def collect_timing(root: pathlib.Path, sf: float, seed: int, warm: int, settings: dict) -> dict:
    """Seconds of one cold and ``warm`` warm runs of each TPC-H query over
    memory tables in one ``TorchContext(device="cuda")``, the SQL of
    ``root``'s ``benchmarks/queries`` with its spec constants replaced
    from the data (``tpch.spec_substitutions``)."""
    import torch

    from ballista_tpu_torch.config import BallistaConfig
    from ballista_tpu_torch.exec.context import TorchContext
    from ballista_tpu_torch.tpch import gen_all, spec_substitutions

    data = gen_all(sf, seed)
    ctx = TorchContext(BallistaConfig(settings), device="cuda")
    for name, t in data.items():
        ctx.register_table(name, t)
    out = {}
    for i in range(1, 23):
        q = f"q{i}"
        sql = (root / "benchmarks" / "queries" / f"{q}.sql").read_text()
        for old, new in spec_substitutions(q, data).items():
            sql = sql.replace(old, new)
        secs = []
        for _ in range(1 + warm):
            t = time.perf_counter()
            ctx.sql(sql).collect()
            torch.cuda.synchronize()
            secs.append(time.perf_counter() - t)
        out[q] = dict(cold_s=secs[0], warm_s=secs[1:], median_warm_s=sorted(secs[1:])[warm // 2])
    return out


# -- phase 19: the mesh tier ---------------------------------------------------

# (a)'s exchange: 2^21 rows over 8 shards. (b) and (c) run the SQL on a mesh
# of MESH_SHARDS shards, q5 on MESH_Q5_SHARDS: a mesh join's output holds
# N times the larger input's capacity, so q5's five chained joins grow its
# batches N^5-fold (PERF.md, phase 19's memory reckoning)
EXCHANGE_SHARDS = 8
MESH_SHARDS = 4
MESH_Q5_SHARDS = 2
MESH_WARM = 3
ORDERS_SORT_SQL = (
    "select o_orderkey, o_custkey, o_totalprice, o_orderdate from orders "
    "order by o_totalprice desc, o_orderkey"
)
MESH_QUERIES = ("q1", "q3", "q5", "q18", "sort", "window")
# the mesh operators each query's plan must hold
MESH_OPS = {
    "q1": ("MeshAggregateExec", "MeshSortExec(ici-sample-sort)"),
    "q3": ("MeshJoinExec", "MeshAggregateExec", "MeshSortExec(ici-all_gather, fetch=10)"),
    "q5": ("MeshJoinExec", "MeshAggregateExec", "MeshSortExec(ici-sample-sort)"),
    "q18": ("MeshJoinExec(semi", "MeshJoinExec(inner", "MeshAggregateExec", "MeshSortExec(ici-all_gather"),
    "sort": ("MeshSortExec(ici-sample-sort)",),
    "window": ("MeshWindowExec",),
}
MESH_TABLES = ("lineitem", "orders", "customer", "nation", "region", "supplier")


def total_device_ms(fn, iters: int = 20) -> float:
    """Device time of one ``fn()``: every device kernel, copy and fill of a
    ``torch.profiler`` trace of ``iters`` calls (after a warm-up), summed,
    over ``iters``."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for _ in range(3):
        fn()
    for _ in range(3):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        us = sum(
            (getattr(e, "self_device_time_total", None) or getattr(e, "self_cuda_time_total", 0))
            for e in prof.key_averages() if getattr(e, "device_type", None) == DeviceType.CUDA
        )
        if us:
            return us / 1e3 / iters
    raise SmokeFailure("profiler: no device time in three traces")


def mesh_exchange(seed: int) -> dict:
    """(a) ``exchange_by_key`` over 2^21 rows on 8 shards of the card: an
    int64 key over 101 values with 10% nulls and an int64 row id. Every
    live row arrives exactly once, on the shard its hash (a numpy
    splitmix64) names; the ids, rows, valid mask and overflow flags equal
    the same call on CPU tensors bit for bit; a small bucket capacity sets
    the overflow flag. Times: device ms (``torch.profiler``, 20 calls),
    call ms (CUDA events) and the bound (every byte read and written once
    at the card's memory rate)."""
    import numpy as np
    import torch

    from ballista_tpu_torch.columnar.batch import DeviceBatch
    from ballista_tpu_torch.datatypes import DataType, Field, Schema
    from ballista_tpu_torch.ops import partition
    from ballista_tpu_torch.parallel import make_mesh, shard_batch
    from ballista_tpu_torch.parallel.collective import exchange_by_key
    from ballista_tpu_torch.parallel.mesh import SHARD_AXIS

    N = EXCHANGE_SHARDS
    g = np.random.default_rng(seed)
    n = 1 << 21
    k = g.integers(0, 101, n)
    knull = g.uniform(size=n) < 0.1
    schema = Schema([Field("k", DataType.INT64, True), Field("row", DataType.INT64, False)])
    batch = DeviceBatch.from_host(schema, [k, np.arange(n)], nulls=[knull, None], device="cuda")
    sb = shard_batch(make_mesh(N, device="cuda"), batch)
    cap = sb.capacity // N

    def call(sbatch, bcap):
        return exchange_by_key(sbatch.columns, sbatch.nulls, sbatch.valid, (0,), SHARD_AXIS, N, bcap)

    before = partition.launches
    cols, nulls, valid, ovf = call(sb, cap)
    torch.cuda.synchronize()
    check(partition.launches - before == 1, "exchange: not one partition-hash launch")
    check(not bool(ovf.any()), "exchange: overflow at the skew-proof bucket capacity")
    v = valid.cpu().numpy()
    rows = cols[1].cpu().numpy()
    check(np.array_equal(np.sort(rows[v]), np.arange(n)), "exchange: a row lost or doubled")
    h = splitmix64_numpy([cols[0].cpu().numpy()[v]], [nulls[0].cpu().numpy()[v]])
    shard = np.arange(len(v)) // (len(v) // N)
    check(np.array_equal((h % np.uint64(N)).astype(np.int64), shard[v]),
          "exchange: a row on another shard than its hash names")
    cpu = DeviceBatch(
        schema=sb.schema, columns=tuple(c.cpu() for c in sb.columns), valid=sb.valid.cpu(),
        nulls=tuple(None if m is None else m.cpu() for m in sb.nulls), dictionaries={}, shards=N,
    )
    ids = partition.partition_ids_for([sb.columns[0]], [sb.nulls[0]], sb.valid, N)
    ids_cpu = partition.partition_ids_for([cpu.columns[0]], [cpu.nulls[0]], cpu.valid, N)
    ccols, cnulls, cvalid, covf = call(cpu, cap)
    check(torch.equal(ids.cpu(), ids_cpu), "exchange: ids differ from the CPU's")
    check(all(torch.equal(a.cpu(), b) for a, b in zip(cols, ccols)), "exchange: rows differ from the CPU's")
    check(torch.equal(nulls[0].cpu(), cnulls[0]), "exchange: null masks differ from the CPU's")
    check(torch.equal(valid.cpu(), cvalid) and torch.equal(ovf.cpu(), covf),
          "exchange: valid or overflow differ from the CPU's")
    small = 1024
    *_, ovf_small = call(sb, small)
    check(bool(ovf_small.all()), f"exchange: bucket capacity {small} set no overflow flag")
    out_len = valid.shape[0]
    row_bytes = 8 + 1 + 8 + 1  # key, its null flag, row id, valid
    nbytes = row_bytes * (sb.capacity + out_len)
    out = dict(
        n=n, shards=N, bucket_cap=cap, out_rows=out_len,
        device_ms=total_device_ms(lambda: call(sb, cap)),
        ms=time_ms(lambda: call(sb, cap)),
        bound_ms=nbytes / HBM_BYTES_PER_S * 1e3, bound_by="bytes",
        bytes=nbytes, small_bucket_cap=small, bit_for_bit_cpu=True,
    )
    partition.launches = before  # comparisons, not the main path
    log(f"mesh exchange: ok  {json.dumps(out)}")
    return out


def mesh_window_check(tag: str, got, want, orderdate) -> None:
    """The window query held tie by tie: rn and rk exactly per order; the
    running frame aggregates, whose order among orders of one customer on
    one date follows the input's row order, by the last value of each
    (customer, date) peer group, floats within rtol 1e-9. ``orderdate``
    maps an order key to its date (a numpy array indexed by key)."""
    import numpy as np

    g, w = ({c: t.column(c).to_numpy() for c in t.column_names} for t in (got, want))
    og, ow = np.argsort(g["o_orderkey"]), np.argsort(w["o_orderkey"])
    for c in ("o_orderkey", "o_custkey", "rn", "rk"):
        check(np.array_equal(g[c][og], w[c][ow]), f"{tag}: {c} differs from collect mode")
    peaks = []
    for t in (g, w):
        key = (t["o_custkey"].astype(np.int64) << 20) | orderdate[t["o_orderkey"]]
        order = np.argsort(key, kind="stable")
        ks = key[order]
        starts = np.flatnonzero(np.r_[True, ks[1:] != ks[:-1]])
        peaks.append([np.maximum.reduceat(t[c][order], starts) for c in ("running_total", "running_max")])
    for c, a, b in zip(("running_total", "running_max"), *peaks):
        check(np.allclose(a, b, rtol=1e-9, atol=0.0), f"{tag}: {c} differs from collect mode")


def mesh_sql(data: dict, oracles: dict, rec: "LaunchRecorder", prec: "PartitionRecorder") -> dict:
    """(b) q1, q3, q5, q18, a full ORDER BY of orders and the window query
    on the mesh (``TorchContext(device="cuda")`` with
    ``BALLISTA_TPU_MESH_SHARDS`` at ``MESH_SHARDS``, q5 at
    ``MESH_Q5_SHARDS``) beside a collect-mode context: each plan holds its
    mesh operators; one cold run, then ``MESH_WARM`` warm runs with the mesh
    and in collect mode in turns; every run held against the numpy oracle
    (q1, q3, q5, q18) and the collect run (keys, counts and row order
    exactly, floats within rtol 1e-9; the window's ties as
    ``mesh_window_check`` holds them); the warm mesh runs bit for bit."""
    import os

    import torch

    from ballista_tpu_torch.exec.context import TorchContext
    from ballista_tpu_torch.ops import onehot_agg, partition, prefix_sum
    from ballista_tpu_torch.parallel import stage

    sqls = {q: (ROOT / "benchmarks" / "queries" / f"{q}.sql").read_text() for q in ("q1", "q3", "q5", "q18")}
    sqls.update(sort=ORDERS_SORT_SQL, window=WINDOW_SQL)
    ctxs = {}
    old = os.environ.get("BALLISTA_TPU_MESH_SHARDS")
    try:
        for shards in (MESH_SHARDS, MESH_Q5_SHARDS, None):
            if shards is None:
                os.environ.pop("BALLISTA_TPU_MESH_SHARDS", None)
            else:
                os.environ["BALLISTA_TPU_MESH_SHARDS"] = str(shards)
            c = TorchContext(device="cuda")
            rt = c.mesh_runtime()  # the shard count is read once, here
            check((rt.mesh.n_dev if rt else None) == shards, f"mesh context of {shards} shards")
            for name in MESH_TABLES:
                c.register_table(name, data[name])
            ctxs[shards] = c
    finally:
        if old is None:
            os.environ.pop("BALLISTA_TPU_MESH_SHARDS", None)
        else:
            os.environ["BALLISTA_TPU_MESH_SHARDS"] = old
    collect = ctxs[None]
    import numpy as np

    okey = data["orders"].column("o_orderkey").to_numpy()
    orderdate = np.zeros(int(okey.max()) + 1, dtype=np.int32)
    orderdate[okey] = data["orders"].column("o_orderdate").cast("int32").to_numpy()

    def one_run(ctx, tag, sql):
        onehot_agg.launches = partition.launches = partition.group_launches = 0
        p0, r0 = prefix_sum.launches, stage.retries
        rec.tag = prec.tag = tag
        torch.cuda.reset_peak_memory_stats()
        try:
            t = time.perf_counter()
            df = ctx.sql(sql)
            res = df.collect()
            torch.cuda.synchronize()
            secs = time.perf_counter() - t
        finally:
            rec.tag = prec.tag = None
        return dict(s=secs, table=res, peak=torch.cuda.max_memory_allocated(),
                    launches={"onehot": onehot_agg.launches, "partition": partition.launches,
                              "grouped": partition.group_launches, "prefix": prefix_sum.launches - p0},
                    retries=stage.retries - r0 + df.stats.get("capacity_retries", 0))

    def held(tag, q, got, want_collect):
        if q in oracles:
            compare(tag, got, oracles[q])
        if q == "window":
            mesh_window_check(tag, got, want_collect, orderdate)
        else:
            compare_tables(tag, got, want_collect)

    out, tables = {}, {}
    totals = {"onehot": 0, "partition": 0, "grouped": 0, "prefix": 0}
    for q in MESH_QUERIES:
        sql = sqls[q]
        shards = MESH_Q5_SHARDS if q == "q5" else MESH_SHARDS
        ctx = ctxs[shards]
        disp = ctx.create_physical_plan(ctx.sql_to_logical(sql)).display()
        for op in MESH_OPS[q]:
            check(op in disp, f"{q}-mesh: no {op} in the plan:\n{disp}")
        tag = f"{q}-mesh"
        tq = time.perf_counter()
        rec.keep = prec.keep = rec.keep_on_host = prec.keep_on_host = rec.keep_prefix = True
        try:
            cold = one_run(ctx, tag, sql)
        finally:
            rec.keep = prec.keep = rec.keep_on_host = prec.keep_on_host = rec.keep_prefix = False
        coll = [one_run(collect, f"{q}-collect", sql)]
        held(f"{tag} cold", q, cold["table"], coll[0]["table"])
        warm = []
        for i in range(MESH_WARM):
            warm.append(one_run(ctx, tag, sql))
            coll.append(one_run(collect, f"{q}-collect", sql))
            held(f"{tag} warm {i}", q, warm[-1]["table"], coll[-1]["table"])
        for r in warm[1:]:
            check(r["table"].equals(warm[0]["table"]), f"{tag}: two warm runs differ")
        for r in [cold] + warm + coll:
            for kk in totals:
                totals[kk] += r["launches"][kk]
        mesh_launches = [r["launches"] for r in [cold] + warm]
        # the sample sort's range exchange routes by splitters, not by hash
        if q != "sort":
            check(all(r["partition"] > 0 for r in mesh_launches), f"{tag}: a run launched no partition hash")
        if q not in ("sort", "window"):
            check(all(r["prefix"] > 0 for r in mesh_launches), f"{tag}: a run launched no prefix sum")
        out[q] = dict(
            shards=shards, rows=cold["table"].num_rows,
            cold_s=cold["s"], warm_s=[r["s"] for r in warm],
            collect_cold_s=coll[0]["s"], collect_warm_s=[r["s"] for r in coll[1:]],
            peak_bytes=max(r["peak"] for r in [cold] + warm),
            collect_peak_bytes=max(r["peak"] for r in coll),
            launches=mesh_launches, collect_launches=[r["launches"] for r in coll],
            retries=[r["retries"] for r in [cold] + warm],
            plan=disp, s=time.perf_counter() - tq,
        )
        log(f"{tag}: ok  {json.dumps({k: v for k, v in out[q].items() if k != 'plan'})}")
        tables[q] = warm[0]["table"]
    return out, totals, tables


def mesh_cluster(data: dict, want) -> dict:
    """(c) A standalone cluster whose one executor advertises
    ``MESH_SHARDS`` devices runs q3: the scheduler's stage plans and the
    operators the executor reports hold the mesh operators, and the result
    equals (b)'s bit for bit."""
    import os

    from ballista_tpu_torch.client.context import BallistaContext
    from ballista_tpu_torch.ops import onehot_agg, partition, prefix_sum

    sql = (ROOT / "benchmarks" / "queries" / "q3.sql").read_text()
    old = os.environ.get("BALLISTA_TPU_MESH_SHARDS")
    os.environ["BALLISTA_TPU_MESH_SHARDS"] = str(MESH_SHARDS)
    onehot_agg.launches = partition.launches = partition.group_launches = 0
    p0 = prefix_sum.launches
    t0 = time.perf_counter()
    dctx = BallistaContext.standalone(device="cuda")
    try:
        sched = dctx._standalone_cluster.scheduler
        deadline = time.time() + 30
        devices: list = []
        while time.time() < deadline and not devices:
            devices = [em.specification.n_devices for em in sched.executor_manager.all_executors()]
            time.sleep(0.05)
        check(devices == [MESH_SHARDS], f"q3-mesh-cluster: executors advertise {devices}")
        for name in ("customer", "orders", "lineitem"):
            dctx.register_table(name, data[name])
        t = time.perf_counter()
        got = dctx.sql(sql).collect()
        secs = time.perf_counter() - t
        (job,) = sched.jobs.values()
        stage_disp = "\n".join(s.plan.display() for s in job.stages.values())
        ran = {r["operator"] for records in job.op_metrics.values() for r in records}
    finally:
        dctx.close()
        if old is None:
            os.environ.pop("BALLISTA_TPU_MESH_SHARDS", None)
        else:
            os.environ["BALLISTA_TPU_MESH_SHARDS"] = old
    for op in ("MeshJoinExec", "MeshAggregateExec", "MeshSortExec"):
        check(op in stage_disp, f"q3-mesh-cluster: no {op} in the stage plans:\n{stage_disp}")
        check(op in ran, f"q3-mesh-cluster: the executor ran no {op}: {sorted(ran)}")
    check(got.equals(want), "q3-mesh-cluster: differs from the mesh context's result")
    out = dict(s=secs, total_s=time.perf_counter() - t0, stages=len(job.stages),
               executor_devices=devices, operators=sorted(ran),
               launches={"onehot": onehot_agg.launches, "partition": partition.launches,
                         "grouped": partition.group_launches, "prefix": prefix_sum.launches - p0})
    log(f"q3-mesh-cluster: ok  {json.dumps(out)}")
    return out


def mesh_path(data: dict, oracles: dict, rec: "LaunchRecorder", prec: "PartitionRecorder") -> dict:
    """Phase 19: (a) the exchange, (b) SQL on the mesh, (c) the scheduler
    path. Returns the phase's results and its main-path launches by kernel
    ((b)'s and (c)'s runs; (a)'s calls are comparisons)."""
    import gc

    import torch

    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    ex = mesh_exchange(seed=19)
    ex["s"] = time.perf_counter() - t0
    sql, totals, tables = mesh_sql(data, oracles, rec, prec)
    cl = mesh_cluster(data, tables["q3"])
    for k in totals:
        totals[k] += cl["launches"][k]
    out = dict(exchange=ex, sql=sql, cluster=cl, s=time.perf_counter() - t0,
               launches=totals["onehot"], partition_launches=totals["partition"],
               grouped_launches=totals["grouped"], prefix_launches=totals["prefix"])
    log(f"phase 19: launches {json.dumps(totals)}, {out['s']:.1f}s")
    return out


def mesh_oracles(data: dict) -> dict:
    h = host_columns(data)
    return {"q1": oracle_q1(lineitem_columns(data["lineitem"])), "q3": oracle_q3(h),
            "q5": oracle_q5(h), "q18": oracle_q18(h)}


def mesh_only(sf: float, seed: int) -> dict:
    """``--mesh-only``: phase 19 alone on TPC-H at ``sf``, with the oracles
    computed here, and its kernels' launches replayed against their plain
    versions."""
    from ballista_tpu_torch.tpch import gen_all

    t0 = time.perf_counter()
    data = gen_all(sf, seed)
    oracles = mesh_oracles(data)
    log(f"tpch sf={sf} seed={seed} and the oracles in {time.perf_counter() - t0:.1f}s")
    with LaunchRecorder() as rec, PartitionRecorder() as prec:
        out = mesh_path(data, oracles, rec, prec)
        t0 = time.perf_counter()
        out["replays"] = replay_launches(rec) + replay_partition_launches(prec)
        out["prefix_replays"] = replay_prefix_launches(rec)
        out["replay_s"] = time.perf_counter() - t0
        log(f"phase 19: replays {out['replay_s']:.1f}s")
    check(bool(out["replays"]) and bool(out["prefix_replays"]), "phase 19: no launch replayed")
    return out


# -- phase 20: the runtime witnesses on the card ----------------------------

WITNESS_QUERIES = ("q1", "q3")
# (b)'s session: the default partitions (2), the result cache, AQE and
# phase 10 (d)'s eager wait (its liveness knobs go to the cluster)
WITNESS_SETTINGS = {"ballista.tpu.result_cache_mb": "64", "ballista.tpu.aqe": "true",
                    "ballista.tpu.eager_wait_s": "5"}
# (c): three of the replay property's configurations
REPLAY_CONFIGS = (
    {"ballista.tpu.shuffle_fetch_concurrency": "1"},
    {"ballista.tpu.eager_shuffle": "false"},
    {"ballista.tpu.shuffle_compression": "zstd"},
)
KERNEL_COUNTS = ("onehot", "partition", "grouped", "prefix")


class kernel_counts:
    """The four launch counts of one run: set to 0 on entry (the prefix
    sum's read as a difference, since the phases' sum is checked), read on
    exit into ``self.n`` and added to ``totals``."""

    def __init__(self, totals: dict) -> None:
        self.totals = totals

    def __enter__(self) -> "kernel_counts":
        from ballista_tpu_torch.ops import onehot_agg, partition, prefix_sum

        onehot_agg.launches = partition.launches = partition.group_launches = 0
        self.p0 = prefix_sum.launches
        return self

    def __exit__(self, *exc) -> None:
        from ballista_tpu_torch.ops import onehot_agg, partition, prefix_sum

        self.n = dict(onehot=onehot_agg.launches, partition=partition.launches,
                      grouped=partition.group_launches, prefix=prefix_sum.launches - self.p0)
        for k in KERNEL_COUNTS:
            self.totals[k] += self.n[k]


def witness_plan_cache(ctx, results: dict, rec: "LaunchRecorder", prec: "PartitionRecorder") -> dict:
    """(a) The context's arm of the staleness witness, on phase 5's
    ``TorchContext`` after its timed runs: each of phase 5's queries once
    more with ``stalewitness`` on at sample rate 1. Each run is a
    physical-plan-cache hit that plans afresh and compares the renders:
    one ``physical_plan_cache`` match a query, no stale, and each result
    bit for bit phase 5's warm one. Phase 5's capture runs plan afresh
    and empty the plan cache as they go, so an unwitnessed run of each
    query caches its plan again first (``seed_s``)."""
    from ballista_tpu_torch.analysis import stalewitness

    t0 = time.perf_counter()
    totals = dict.fromkeys(KERNEL_COUNTS, 0)
    out: dict = {"runs": {}}
    stalewitness.reset()
    stalewitness.set_sample_rate(1.0)
    rec.keep = prec.keep = rec.keep_on_host = prec.keep_on_host = rec.keep_prefix = True

    def one_run(tag: str, sql: str):
        rec.tag = prec.tag = tag
        try:
            with kernel_counts(totals) as kc:
                t = time.perf_counter()
                got = ctx.sql(sql).collect()
                secs = time.perf_counter() - t
        finally:
            rec.tag = prec.tag = None
        return got, secs, kc.n

    try:
        seeded = {}
        for q in JOIN_QUERIES:
            got, seeded[q], _ = one_run(f"{q}-witness", results[q][0])
            check(got.equals(results[q][1]), f"{q}-witness seed run: differs from phase 5's warm result")
        check(len(ctx._physical_cache) >= len(JOIN_QUERIES), "witness (a): the plans were not cached")
        out["seed_s"] = sum(seeded.values())
        stalewitness.enable()
        for q in JOIN_QUERIES:
            sql, want = results[q]
            tag = f"{q}-witness"
            matches = stalewitness.counters().get(("physical_plan_cache", "match"), 0)
            got, secs, n = one_run(tag, sql)
            checked = stalewitness.counters().get(("physical_plan_cache", "match"), 0) - matches
            check(checked == 1, f"{tag}: {checked} physical_plan_cache matches, not 1")
            check(got.equals(want), f"{tag}: differs from phase 5's warm result")
            out["runs"][tag] = dict(s=secs, seed_s=seeded[q], **n)
            log(f"{tag}: ok  {json.dumps(out['runs'][tag])}")
        hits = stalewitness.hit_counts()
        check(hits == {"physical_plan_cache": len(JOIN_QUERIES)}, f"witness (a): hits {hits}")
        stalewitness.assert_no_stale()
        out["counters"] = {f"{c}:{o}": n for (c, o), n in sorted(stalewitness.counters().items())}
    finally:
        rec.keep = prec.keep = rec.keep_on_host = prec.keep_on_host = rec.keep_prefix = False
        stalewitness.enable(False)
        stalewitness.reset()
    out["launches"] = totals
    out["s"] = time.perf_counter() - t0
    log(f"witness (a): {json.dumps(out['counters'])}, launches {json.dumps(totals)}, {out['s']:.1f}s")
    return out


def drain_pending(what: str, timeout: float = 60.0) -> None:
    """Wait, with a deadline, until every demoted hit has resolved: the
    scheduler repopulates on a thread of its own."""
    from ballista_tpu_torch.analysis import stalewitness

    deadline = time.monotonic() + timeout
    while stalewitness.pending_count() and time.monotonic() < deadline:
        time.sleep(0.02)
    check(stalewitness.pending_count() == 0, f"{what}: {stalewitness.pending_count()} demoted hits never resolved")


def kill_last_writer(cl, job_id: str, stage_id: int) -> str:
    """Kill the executor that ran the last task of a stage that has just
    finished, so that the loss takes shuffle output which the stage's
    consumer has yet to read. An executor that holds none of it may leave
    only running tasks, which the expiry sweep requeues without a retry or
    a recompute. Returns the dead executor's id."""
    tasks = cl.scheduler.stage_manager._stages[(job_id, stage_id)].tasks
    victim = max((t for t in tasks if t.executor_id), key=lambda t: t.ended_s).executor_id
    index = next(i for i, h in enumerate(cl.executors) if h.alive and h.executor.executor_id == victim)
    return cl.kill_executor(index)


def witness_cluster(data: dict, oracles: dict, collected: dict, rec: "LaunchRecorder",
                    prec: "PartitionRecorder") -> dict:
    """(b) The chaos scenario of ``tests/test_stalewitness_chaos.py`` on the
    card: a two-executor cluster (the result cache at 64 MB, AQE on, phase
    10 (d)'s liveness knobs) with the cache witness sampling every hit and
    the replay and resource witnesses on. q1 and q3 cold; q3 again (its hit
    demoted, resolving ``match``); q3 losing, at its first finished
    stage, the executor that ran that stage's last task; ``customer``
    registered again as the same object (its key flips: q3 misses); rows
    appended to ``customer`` that q3's segment filter drops (q3 misses
    again). Every result equals collect mode's and
    the numpy oracle, money sums bit for bit; no stale hit, nothing
    pending, at least one ``result_cache`` match; the replay ledger clean
    with shuffle and result records; after the cluster closed, the
    resource witness drained."""
    import pyarrow as pa

    from ballista_tpu_torch.analysis import replay, reswitness, stalewitness
    from ballista_tpu_torch.client.context import BallistaContext
    from ballista_tpu_torch.client.flight import close_pool
    from ballista_tpu_torch.config import BallistaConfig

    sqls = {q: (ROOT / "benchmarks" / "queries" / f"{q}.sql").read_text() for q in WITNESS_QUERIES}
    t0 = time.perf_counter()
    totals = dict.fromkeys(KERNEL_COUNTS, 0)
    out: dict = {"runs": {}}
    # earlier phases' clusters have closed, and the witness was off for
    # them: it records this scenario's resources only
    reswitness.reset()
    reswitness.enable(True)
    stalewitness.reset()
    stalewitness.enable()
    stalewitness.set_sample_rate(1.0)
    replay.reset()
    replay.enable()
    rec.keep = prec.keep = rec.keep_on_host = prec.keep_on_host = rec.keep_prefix = True
    ctx = None
    try:
        ctx = BallistaContext.standalone(
            BallistaConfig(WITNESS_SETTINGS), device="cuda", n_executors=2, concurrent_tasks=2,
            executor_timeout_s=5.0, expiry_check_interval_s=1.0,
        )
        cl = ctx._standalone_cluster
        sched = cl.scheduler
        for name, tab in data.items():
            ctx.register_table(name, tab)

        def one_run(tag: str, q: str) -> dict:
            cache0 = sched.result_cache.stats()
            jobs0 = set(sched.jobs)
            rec.tag = prec.tag = tag
            try:
                with kernel_counts(totals) as kc:
                    t = time.perf_counter()
                    res = ctx.sql(sqls[q]).collect()
                    secs = time.perf_counter() - t
            finally:
                rec.tag = prec.tag = None
            new = set(sched.jobs) - jobs0
            check(len(new) == 1, f"{tag}: {len(new)} jobs ran")
            job = sched.jobs[new.pop()]
            check(job.status == "completed", f"{tag}: job {job.job_id} {job.status} {job.error}")
            want = collected[q]
            compare_tables(tag, res, want)
            for c in STAGED_EXACT.get(q, ()):
                check(res.column(c).equals(want.column(c)), f"{tag}: {c} not bit for bit")
            compare(tag, res, oracles[q])
            cache1 = sched.result_cache.stats()
            run = dict(s=secs, **kc.n, hits=cache1["hits"] - cache0["hits"],
                       misses=cache1["misses"] - cache0["misses"], task_retries=job.total_retries,
                       recomputes=job.total_recomputes, rewrites=job.total_rewrites)
            out["runs"][tag] = run
            log(f"{tag}: ok  {json.dumps(run)}")
            return run

        def wait_entries(n: int) -> None:
            deadline = time.monotonic() + 30
            while sched.result_cache.stats()["entries"] < n and time.monotonic() < deadline:
                time.sleep(0.02)
            check(sched.result_cache.stats()["entries"] >= n, f"witness (b): {sched.result_cache.stats()}")

        # 1. cold; 2. q3's hit, demoted, must resolve match
        for q in WITNESS_QUERIES:
            check(one_run(f"{q}-witness-cold", q)["misses"] == 1, f"{q}-witness-cold: not a miss")
        wait_entries(2)
        check(one_run("q3-witness-demoted", "q3")["hits"] == 1, "q3-witness-demoted: not a hit")
        drain_pending("witness (b) demoted")
        check(stalewitness.counters().get(("result_cache", "match"), 0) == 1,
              f"witness (b): {stalewitness.summary()}")

        # 3. an executor lost at the first finished stage of a demoted q3
        wait_entries(2)
        killed: list = []
        expired: list = []
        finished, sweep = sched._on_stage_finished, sched.check_expired_executors

        def on_stage_finished(job_id, stage_id):
            if not killed:
                killed.append(kill_last_writer(cl, job_id, stage_id))
            finished(job_id, stage_id)

        def check_expired():
            ids = sweep()
            expired.extend(ids)
            return ids

        sched._on_stage_finished = on_stage_finished
        sched.check_expired_executors = check_expired
        try:
            loss = one_run("q3-witness-loss", "q3")
        finally:
            sched._on_stage_finished = finished
        deadline = time.monotonic() + 15
        while not expired and time.monotonic() < deadline:
            time.sleep(0.1)
        sched.check_expired_executors = sweep
        check(bool(killed) and expired == killed, f"witness (b): killed {killed}, scheduler reported {expired}")
        check(loss["hits"] == 1, "q3-witness-loss: not a (demoted) hit")
        check(loss["task_retries"] + loss["recomputes"] > 0, "q3-witness-loss: nothing was recomputed")
        drain_pending("witness (b) loss")
        check(stalewitness.counters().get(("result_cache", "match"), 0) == 2,
              f"witness (b) after the loss: {stalewitness.summary()}")
        out["killed"] = killed

        # 4. the same object registered again: a new generation, a miss
        ctx.register_table("customer", data["customer"])
        check(one_run("q3-witness-reregistered", "q3")["misses"] == 1,
              "q3-witness-reregistered: the key did not flip")
        # 5. rows appended that q3's segment filter drops: a miss, the
        # same rows
        cust = data["customer"]
        extra = cust.slice(0, 8)
        extra = extra.set_column(
            0, "c_custkey", pa.array(range(cust.num_rows + 1, cust.num_rows + 9), pa.int64())
        ).set_column(6, "c_mktsegment", pa.array(["AUTOMOBILE"] * 8))
        ctx.append_table("customer", extra)
        check(one_run("q3-witness-appended", "q3")["misses"] == 1, "q3-witness-appended: the key did not flip")
        drain_pending("witness (b) end")

        stalewitness.assert_no_stale()
        counters = stalewitness.counters()
        check(counters.get(("result_cache", "match"), 0) >= 1, f"witness (b): {stalewitness.summary()}")
        out["cache_counters"] = {f"{c}:{o}": n for (c, o), n in sorted(counters.items())}
        out["cache_hits"] = stalewitness.hit_counts()
        replay.assert_clean()
        records = replay.record_counts()
        check(records.get("shuffle", 0) > 0 and records.get("result", 0) > 0, f"witness (b): replay {records}")
        out["replay_records"] = records
        out["replay"] = replay.summary()
    finally:
        rec.keep = prec.keep = rec.keep_on_host = prec.keep_on_host = rec.keep_prefix = False
        leaked = None
        try:
            if ctx is not None:
                ctx.close()
            close_pool()
            deadline = time.monotonic() + 30
            while reswitness.live() and time.monotonic() < deadline:
                time.sleep(0.1)
            out["acquired"] = reswitness.acquired_counts()
            out["live_after_close"] = len(reswitness.live())
            try:
                reswitness.assert_drained()
            except AssertionError as e:
                leaked = str(e)
        finally:
            reswitness.enable(False)
            reswitness.reset()
            stalewitness.enable(False)
            stalewitness.reset()
            replay.enable(False)
            replay.reset()
    check(leaked is None, f"witness (b): resources live after the cluster closed: {leaked}")
    check(totals["onehot"] > 0 and totals["grouped"] > 0 and totals["prefix"] > 0,
          f"witness (b): the queries did not launch every kernel {totals}")
    out["launches"] = totals
    out["s"] = time.perf_counter() - t0
    log(f"witness (b): cache {json.dumps(out['cache_counters'])}; replay records "
        f"{json.dumps(out['replay_records'])}; resources acquired {json.dumps(out['acquired'])}, "
        f"live after close {out['live_after_close']}; launches {json.dumps(totals)}, {out['s']:.1f}s")
    return out


def witness_replay(data: dict, collected: dict, rec: "LaunchRecorder", prec: "PartitionRecorder") -> dict:
    """(c) The replay property of ``tests/test_replay_witness.py`` on the
    card: q3 on a fresh two-executor cluster under each of
    ``REPLAY_CONFIGS``, the replay witness on; one key set, and every
    shuffle and result hash equal across the three."""
    from ballista_tpu_torch.analysis import replay
    from ballista_tpu_torch.client.context import BallistaContext
    from ballista_tpu_torch.config import BallistaConfig

    sql = (ROOT / "benchmarks" / "queries" / "q3.sql").read_text()
    t0 = time.perf_counter()
    totals = dict.fromkeys(KERNEL_COUNTS, 0)
    out: dict = {"runs": {}}
    snaps = []
    rec.keep = prec.keep = rec.keep_on_host = prec.keep_on_host = rec.keep_prefix = True
    try:
        for settings in REPLAY_CONFIGS:
            tag = "q3-replay-" + "-".join(f"{k.rsplit('.', 1)[1]}={v}" for k, v in settings.items())
            replay.reset()
            replay.enable()
            ctx = BallistaContext.standalone(BallistaConfig(settings), device="cuda", n_executors=2,
                                             concurrent_tasks=2)
            try:
                for name in ("customer", "orders", "lineitem"):
                    ctx.register_table(name, data[name])
                rec.tag = prec.tag = tag
                try:
                    with kernel_counts(totals) as kc:
                        t = time.perf_counter()
                        res = ctx.sql(sql).collect()
                        secs = time.perf_counter() - t
                finally:
                    rec.tag = prec.tag = None
            finally:
                ctx.close()
            compare_tables(tag, res, collected["q3"])
            check(res.column("revenue").equals(collected["q3"].column("revenue")), f"{tag}: revenue not bit for bit")
            replay.assert_clean()
            records = replay.record_counts()
            check(records.get("shuffle", 0) > 0 and records.get("result", 0) > 0, f"{tag}: replay {records}")
            snaps.append((tag, replay.snapshot(strip_job=True)))
            out["runs"][tag] = dict(s=secs, records=records, **kc.n)
            log(f"{tag}: ok  {json.dumps(out['runs'][tag])}")
    finally:
        rec.keep = prec.keep = rec.keep_on_host = prec.keep_on_host = rec.keep_prefix = False
        replay.enable(False)
        replay.reset()
    base_tag, base = snaps[0]
    for tag, snap in snaps[1:]:
        check(set(snap) == set(base), f"{tag}: key set differs from {base_tag}'s: {sorted(set(snap) ^ set(base))[:6]}")
        diff = [k for k in base if snap[k] != base[k]]
        check(not diff, f"{tag}: hashes differ from {base_tag}'s at {diff[:6]}")
    out["keys"] = len(base)
    out["launches"] = totals
    out["s"] = time.perf_counter() - t0
    log(f"witness (c): {len(base)} keys, equal hashes across {len(snaps)} configurations; "
        f"launches {json.dumps(totals)}, {out['s']:.1f}s")
    return out


def witness_path(data: dict, oracles: dict, collected: dict, rec: "LaunchRecorder",
                 prec: "PartitionRecorder") -> dict:
    """Phase 20's (b) and (c) ((a) runs on phase 5's context right after
    it: ``witness_plan_cache``). Returns their results and launches."""
    import gc

    import torch

    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    out = {"cluster": witness_cluster(data, oracles, collected, rec, prec),
           "replay": witness_replay(data, collected, rec, prec)}
    out["launches"] = {k: out["cluster"]["launches"][k] + out["replay"]["launches"][k] for k in KERNEL_COUNTS}
    out["s"] = time.perf_counter() - t0
    return out


def witness_only(sf: float, seed: int, warm: int) -> dict:
    """``--witness-only``: phase 5 and phase 20 alone, on TPC-H at ``sf``:
    phase 5's queries on one ``TorchContext(device="cuda")`` against their
    oracles (the context (a) runs on), q1 and q3 in collect mode on it for
    (b) and (c), then every launch replayed against its plain version."""
    from ballista_tpu_torch.tpch import gen_all

    t0 = time.perf_counter()
    data = gen_all(sf, seed)
    oracles = {"q1": oracle_q1(lineitem_columns(data["lineitem"]))}
    log(f"tpch sf={sf} seed={seed} and q1's oracle in {time.perf_counter() - t0:.1f}s")
    with LaunchRecorder() as rec, PartitionRecorder() as prec:
        jp = joins_path(data, warm, False, rec, prec)
        replay_launches(rec)
        replay_partition_launches(prec)
        oracles.update({q: jp["oracles"][q] for q in ("q3",)})
        ctx = jp.pop("ctx")
        collected = {q: ctx.sql((ROOT / "benchmarks" / "queries" / f"{q}.sql").read_text()).collect()
                     for q in WITNESS_QUERIES}
        t0 = time.perf_counter()
        out = {"plan_cache": witness_plan_cache(ctx, jp["results"], rec, prec)}
        del ctx
        out.update(witness_path(data, oracles, collected, rec, prec))
        t = time.perf_counter()
        out["replays"] = replay_launches(rec) + replay_partition_launches(prec)
        out["prefix_replays"] = replay_prefix_launches(rec)
        out["replay_s"] = time.perf_counter() - t
        check(bool(out["replays"]) and bool(out["prefix_replays"]), "phase 20: no launch replayed")
        out["phase_s"] = time.perf_counter() - t0
    return out


# -- phase 21: the user surface on the card -----------------------------------

SURFACE_EXAMPLES = ("standalone_sql", "remote_sql", "dataframe", "udf_plugin")
# (b): the size a user would run each example at
SURFACE_ROWS = {"standalone_sql": 1_000_000, "remote_sql": 1_000_000, "dataframe": 16_777_216,
                "udf_plugin": 6_000_000}


def shown_rows(text: str) -> tuple:
    """``DataFrame.show()``'s text as (header, rows), each cell an int, a
    float or a string."""

    def cell(s: str):
        for kind in (int, float):
            try:
                return kind(s)
            except ValueError:
                pass
        return s

    lines = [ln.split() for ln in text.strip().splitlines()]
    return lines[0], [[cell(c) for c in ln] for ln in lines[1:]]


def same_rows(tag: str, got: tuple, want: tuple) -> None:
    """Keys and counts exactly, floats within rtol 1e-9."""
    check(got[0] == want[0] and len(got[1]) == len(want[1]) > 0, f"{tag}: {got} vs {want}")
    for g_row, w_row in zip(got[1], want[1]):
        check(len(g_row) == len(w_row), f"{tag}: {g_row} vs {w_row}")
        for g, w in zip(g_row, w_row):
            if isinstance(w, float):
                check(abs(g - w) <= 1e-9 * abs(w), f"{tag}: {g_row} vs {w_row}")
            else:
                check(g == w and type(g) is type(w), f"{tag}: {g_row} vs {w_row}")


def surface_oracle(name: str, data) -> dict:
    """The example's result computed with numpy from its ``make_data``
    (group counts and sums by ``bincount``)."""
    import numpy as np

    if name in ("standalone_sql", "remote_sql"):
        keys = sorted({r[0] for r in data})
        pos = {k: i for i, k in enumerate(keys)}
        idx = np.fromiter((pos[r[0]] for r in data), dtype=np.int64, count=len(data))
        val = np.fromiter((r[1] for r in data), dtype=np.float64, count=len(data))
        n, sums = np.bincount(idx, minlength=len(keys)), np.bincount(idx, weights=val, minlength=len(keys))
        if name == "standalone_sql":
            return {"region": np.array(keys), "n": n, "total": sums}
        top = np.argsort(-sums, kind="stable")[:5]
        return {"customer": np.array(keys)[top], "n": n[top], "spent": sums[top]}
    cols = {c: data.column(c).to_numpy() for c in data.column_names}
    if name == "dataframe":
        keep = cols["passengers"] > 1
        vendor, fare = cols["vendor"][keep], cols["fare"][keep]
        n = np.bincount(vendor)
        keys = np.flatnonzero(n)
        sums = np.bincount(vendor, weights=fare)[keys]
        return {"vendor": keys, "trips": n[keys], "revenue": sums, "avg_fare": sums / n[keys]}
    x, y = cols["x"], cols["y"]
    return {"n": np.array([len(x)]), "avg_relu_x": np.array([np.maximum(x, 0.0).mean()]),
            "mean_sq_dist": np.array([((x - y) * (x - y)).mean()])}


def held_to_oracle(tag: str, got, want: dict) -> float:
    """``got`` (an Arrow table) against the oracle's columns: keys and
    counts exactly, floats within rtol 1e-9. Returns the largest relative
    difference of a float."""
    import numpy as np

    check(got.column_names == list(want), f"{tag}: columns {got.column_names} vs {list(want)}")
    worst = 0.0
    for c, w in want.items():
        g = got.column(c).to_numpy()
        check(len(g) == len(w), f"{tag}: {c} has {len(g)} rows, the oracle {len(w)}")
        if w.dtype.kind == "f":
            rel = float((np.abs(g - w) / np.abs(w)).max())
            check(rel <= 1e-9, f"{tag}: {c} {g.tolist()} vs {w.tolist()} (rel {rel:.3e})")
            worst = max(worst, rel)
        else:
            check(g.tolist() == w.tolist(), f"{tag}: {c} {g.tolist()} vs {w.tolist()}")
    return worst


def surface_path(pkg_root: pathlib.Path, rec: "LaunchRecorder", prec: "PartitionRecorder") -> dict:
    """Phase 21: (a) the four examples' ``main`` on the card and on the CPU
    at the reference's row counts, (b) each at a user's size against a
    numpy oracle, (c) one example as a child with its default device.
    Returns the results, the seconds and the launches of (a) and (b)."""
    import contextlib
    import gc
    import importlib
    import io

    import torch

    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    totals = dict.fromkeys(KERNEL_COUNTS, 0)
    out: dict = {"a": {}, "b": {}}
    mods = {name: importlib.import_module(f"ballista_tpu_torch.examples.{name}") for name in SURFACE_EXAMPLES}
    child = subprocess.Popen(
        [sys.executable, "-m", "ballista_tpu_torch.examples.standalone_sql"],
        cwd=pkg_root, env=child_env("off"), stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
    )
    rec.keep = prec.keep = rec.keep_on_host = prec.keep_on_host = rec.keep_prefix = True

    def counted(tag: str, fn):
        rec.tag = prec.tag = tag
        try:
            with kernel_counts(totals) as kc:
                t = time.perf_counter()
                res = fn()
                secs = time.perf_counter() - t
        finally:
            rec.tag = prec.tag = None
        return res, secs, kc.n

    def printed(name: str, device: str) -> str:
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            mods[name].main(["--device", device])
        return buf.getvalue()

    shown = {}
    try:
        # (a) the reference's row counts, on the card and on the CPU
        for name in SURFACE_EXAMPLES:
            t = time.perf_counter()
            want = printed(name, "cpu")
            cpu_s = time.perf_counter() - t
            text, secs, n = counted(f"{name}-example", lambda: printed(name, "cuda"))
            shown[name] = shown_rows(text)
            same_rows(f"{name} (a)", shown[name], shown_rows(want))
            out["a"][name] = dict(rows=mods[name].ROWS, s=secs, cpu_s=cpu_s, printed=text.strip().splitlines(), **n)
            log(f"surface (a) {name}: ok  {json.dumps(out['a'][name])}")
        # (b) a user's size, against numpy over make_data
        for name in SURFACE_EXAMPLES:
            rows = SURFACE_ROWS[name]
            got, secs, n = counted(f"{name}-user", lambda: mods[name].run(rows, "cuda"))
            t = time.perf_counter()
            rel = held_to_oracle(f"{name} (b)", got, surface_oracle(name, mods[name].make_data(rows)))
            out["b"][name] = dict(rows=rows, s=secs, oracle_s=time.perf_counter() - t, max_rel_diff=rel, **n)
            log(f"surface (b) {name}: ok  {json.dumps(out['b'][name])}")
            del got
        # (c) the module entry point as a user runs it
        t = time.perf_counter()
        stdout, stderr = child.communicate(timeout=300)
        check(child.returncode == 0, f"surface (c): exited {child.returncode}:\n{stdout[-2000:]}\n{stderr[-3000:]}")
        same_rows("standalone_sql (c)", shown_rows(stdout), shown["standalone_sql"])
        out["c"] = dict(wait_s=time.perf_counter() - t, printed=stdout.strip().splitlines())
        log(f"surface (c): ok  {json.dumps(out['c'])}")
    finally:
        rec.keep = prec.keep = rec.keep_on_host = prec.keep_on_host = rec.keep_prefix = False
        if child.poll() is None:
            child.kill()
            child.communicate()
    check(sum(totals.values()) > 0, "phase 21: no kernel launched")
    out["launches"] = totals
    out["s"] = time.perf_counter() - t0
    log(f"phase 21: launches {json.dumps(totals)}, {out['s']:.1f}s")
    return out


def surface_replays(rec: "LaunchRecorder", prec: "PartitionRecorder") -> dict:
    """Phase 21's launches against the plain versions, by kernel."""
    replays = {"onehot": replay_launches(rec), "partition": replay_partition_launches(prec),
               "prefix": replay_prefix_launches(rec)}
    check(any(replays.values()), "phase 21: no launch replayed")
    return replays


def surface_only(pkg_root: pathlib.Path) -> dict:
    """``--surface-only``: phase 21 alone, then its launches replayed."""
    with LaunchRecorder() as rec, PartitionRecorder() as prec:
        out = surface_path(pkg_root, rec, prec)
        t = time.perf_counter()
        out["replays"] = surface_replays(rec, prec)
        out["replay_s"] = time.perf_counter() - t
    return out


def main() -> int:
    t_main = time.perf_counter()
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--sf", type=float, default=1.0)
    ap.add_argument("--seed", type=int, default=42)
    ap.add_argument("--warm", type=int, default=2)
    ap.add_argument(
        "--profile", action="store_true",
        help="after the main path, trace one warm run of each query with "
        "torch.profiler and print the device time by kernel",
    )
    ap.add_argument(
        "--partition-timing", action="store_true",
        help="only build the partition-hash kernel and print its modes' device, "
        "call and host times (partition_timing), then stop",
    )
    ap.add_argument(
        "--collect-timing", action="store_true",
        help="only run the 22 TPC-H queries over memory tables, cold and "
        "--warm times each, print their seconds, then stop",
    )
    ap.add_argument(
        "--aqe-only", action="store_true",
        help="only run phase 13 (AQE on the port's cluster), holding the "
        "five cluster queries against collect mode and the oracles computed "
        "here, then stop",
    )
    ap.add_argument(
        "--prefix-only", action="store_true",
        help="only build the prefix-sum kernel and run phase 3's prefix-sum "
        "checks (the old scan's spread, the kernel against its plain "
        "version, its times), then stop",
    )
    ap.add_argument(
        "--prefix-queries", action="store_true",
        help="only time the two warm queries whose f64 SUMs take the "
        "prefix-sum kernel (phase 14's sort-path query, phase 13 (a) with "
        "AQE off), then stop",
    )
    ap.add_argument(
        "--adaptive-timing", action="store_true",
        help="only time phase 16's six queries (a cold run, then --warm warm "
        "runs at build_cache_mb 0 and at 2048 in turns), then stop",
    )
    ap.add_argument(
        "--analysis-only", action="store_true",
        help="only run phase 17 (the static-analysis gate, and the "
        "durability witness across a scheduler restart with q1 and q3 held "
        "against the oracles computed here), then stop",
    )
    ap.add_argument(
        "--hooks-only", action="store_true",
        help="only run phase 18 (prewarm in two child processes, an "
        "executor's background prewarm beside q1, profile_dir and trace), "
        "then stop",
    )
    ap.add_argument(
        "--mesh-only", action="store_true",
        help="only run phase 19 (the mesh tier: the exchange, SQL on the "
        "mesh against collect mode and the oracles computed here, the "
        "scheduler path), then stop",
    )
    ap.add_argument(
        "--witness-only", action="store_true",
        help="only run phase 5 and phase 20 (the runtime witnesses: the "
        "context's plan-cache arm on phase 5's context, a witnessed "
        "cluster with an executor loss, the replay property), then stop",
    )
    ap.add_argument(
        "--surface-only", action="store_true",
        help="only run phase 21 (the four examples on the card against the CPU "
        "and against numpy oracles at a user's size, one as a child), then stop",
    )
    ap.add_argument(
        "--settings", default="{}",
        help="session settings (a JSON object) of --collect-timing's context",
    )
    ap.add_argument(
        "--root", default=str(ROOT),
        help="the checkout whose ballista_tpu_torch is imported (default: this "
        "script's): time another checkout's kernel in the same call",
    )
    args = ap.parse_args()
    check(args.warm >= 2, "--warm must be at least 2: two warm runs are compared")
    # no persisted hints for phases 3-11 (their cold runs stay cold) or the
    # processes they start; phase 12 (b) gives its children their own
    import os

    os.environ["BALLISTA_TPU_HINT_CACHE"] = "off"

    pkg_root = pathlib.Path(args.root).resolve()
    check((pkg_root / "ballista_tpu_torch").is_dir(), f"no ballista_tpu_torch in {pkg_root}")
    import torch

    check(torch.cuda.is_available(), "no CUDA device: the port's smoke run needs a card")
    sys.path.insert(0, str(pkg_root))
    from ballista_tpu_torch.ops import cuda_build, onehot_agg, partition, prefix_sum

    sources = [onehot_agg.SOURCE, partition.SOURCE, prefix_sum.SOURCE]

    # 1. card
    name = torch.cuda.get_device_name(0)
    count = torch.cuda.device_count()
    smi = nvidia_smi_line()
    log(f"card: {name}, count {count}, torch {torch.__version__}, "
        f"CUDA {torch.version.cuda}; nvidia-smi: {smi}")
    if args.partition_timing:
        path, secs, _ = cuda_build.build(partition.SOURCE)
        log(f"build: {path.name} in {secs:.2f}s (from {pkg_root})")
        log(json.dumps({"partition_timing": partition_timing(seed=15), "root": str(pkg_root)}))
        log(smi)
        return 0
    if args.prefix_only:
        path, secs, report = cuda_build.build(prefix_sum.SOURCE, verbose=True)
        log(f"build: {path.name} in {secs:.2f}s")
        for line in report.splitlines():
            log(f"  nvcc: {line.strip()}")
        log(json.dumps({"prefix": prefix_phase(seed=17)}))
        log(smi)
        return 0
    if args.collect_timing:
        cuda_build.build_many(sources)
        timing = collect_timing(pkg_root, args.sf, args.seed, args.warm, json.loads(args.settings))
        log(json.dumps({"collect_timing": timing, "root": str(pkg_root), "settings": args.settings}))
        log(smi)
        return 0

    if args.adaptive_timing:
        cuda_build.build_many(sources)
        log(json.dumps({"adaptive_timing": adaptive_timing(pkg_root, args.sf, args.seed, args.warm),
                        "root": str(pkg_root)}))
        log(smi)
        return 0

    if args.prefix_queries:
        cuda_build.build_many(sources)
        log(json.dumps({"prefix_queries": prefix_queries(args.sf, args.seed, args.warm),
                        "root": str(pkg_root)}))
        log(smi)
        return 0

    if args.analysis_only:
        cuda_build.build_many(sources)
        log(json.dumps({"phase17": analysis_only(pkg_root, args.sf, args.seed)}, default=str))
        log(smi)
        return 0

    if args.hooks_only:
        cuda_build.build_many(sources)
        log(json.dumps({"phase18": hooks_only(pkg_root, args.sf, args.seed)}, default=str))
        log(smi)
        return 0

    if args.mesh_only:
        cuda_build.build_many(sources)
        log(json.dumps({"phase19": mesh_only(args.sf, args.seed)}, default=str))
        log(smi)
        return 0

    if args.witness_only:
        cuda_build.build_many(sources)
        log(json.dumps({"phase20": witness_only(args.sf, args.seed, args.warm)}, default=str))
        log(smi)
        return 0

    if args.surface_only:
        cuda_build.build_many(sources)
        log(json.dumps({"phase21": surface_only(pkg_root)}, default=str))
        log(smi)
        return 0

    if args.aqe_only:
        cuda_build.build_many(sources)
        log(json.dumps({"aqe": aqe_only(args.sf, args.seed), "root": str(pkg_root)}, default=str))
        log(smi)
        return 0

    # 2. build: the three kernels, one nvcc each, started together
    t0 = time.perf_counter()
    built = cuda_build.build_many(sources, verbose=True)
    for path, secs, report in built:
        log(f"build: {path.name} in {secs:.2f}s")
        for line in report.splitlines():
            if "registers" in line or "smem" in line or "Compiling" in line or "warning" in line:
                log(f"  nvcc: {line.strip()}")
    log(f"build: the kernels in {time.perf_counter() - t0:.2f}s")

    # TPC-H at --sf for phases 4-17; phase 6's CPU runs start now, in a
    # process of their own, beside phases 3-5
    import atexit

    from ballista_tpu_torch.tpch import gen_all

    t0 = time.perf_counter()
    data = gen_all(args.sf, args.seed)
    log(f"tpch sf={args.sf} seed={args.seed}: "
        + ", ".join(f"{k} {t.num_rows}" for k, t in data.items())
        + f" rows, generated in {time.perf_counter() - t0:.1f}s")
    cpu_ref = CpuReference(data, pkg_root)
    atexit.register(cpu_ref.close)

    # 3. kernel vs plain; the sort on the card vs the CPU
    t0 = time.perf_counter()
    cases = [
        kernel_case(1 << 21, 9, 5, 12, seed=1, profiled=True),   # q1 partial, full batch
        kernel_case(1 << 20, 9, 5, 12, seed=2),   # q1 partial, tail batch
        kernel_case(1 << 20, 9, 5, 2048, seed=3),  # the old 2048-slot gate
        kernel_case(1_000_003, 9, 5, 12, seed=4),  # ragged n
        kernel_case(300_001, 16, 48, 37, seed=5),  # R = 64, ragged
        kernel_case(1 << 20, 9, 5, 4096, seed=7),  # several slot chunks
        kernel_case(1 << 21, 9, 5, 65536, seed=8),  # the largest dense space
        kernel_case(1 << 21, 1, 5, 12, seed=9, profiled=True),   # q1 now: one shared count row
        kernel_case(1 << 20, 1, 5, 12, seed=11),  # q1 now, tail batch (padded)
    ]
    sweep = crossover(
        1 << 21, Rs=(1, 2, 6, 14, 64),
        Ps=(1, 4, 12, 32, 128, 512, 2048, 8192, 65536),
        seed=6,
    )
    by_mode = modes(
        1 << 21, Rs=(6, 14), Ps=(256, 2048, 65536),
        dists=("uniform", "zipf", "hot90"), seed=12,
    )
    concurrent = onehot_concurrency(seed=18)
    sorted_ok = sort_check(seed=10)
    pfx = prefix_phase(seed=17)
    pkernel = partition_kernel_phase(seed=14)
    pgroups = partition_groups_phase(seed=16)
    ptiming = partition_timing(seed=15)
    log(f"phase 3 took {time.perf_counter() - t0:.1f}s")

    # 4. main path (q1, q6, the wide GROUP BY)
    t0 = time.perf_counter()
    # the prefix-sum kernel's launches on the main path (phases 4-18), by
    # phase; capture runs and replays set the count back
    prefix_sum.launches = 0
    pl_by_phase: dict = {}

    def prefix_mark(phase: int) -> None:
        pl_by_phase[phase] = prefix_sum.launches - sum(pl_by_phase.values())

    with LaunchRecorder() as rec, PartitionRecorder() as prec:
        mp = main_path(data["lineitem"], args.sf, args.warm, args.profile, rec)
        replays = replay_launches(rec)
        prefix_mark(4)
        log(f"phase 4 took {time.perf_counter() - t0:.1f}s")

        # 5. joins and the sort-based aggregate
        t0 = time.perf_counter()
        hashed = hash_check(seed=13)
        decimal = decimal_check()
        jp = joins_path(data, args.warm, args.profile, rec, prec)
        replays += replay_launches(rec)
        preplays = replay_partition_launches(prec)
        prefix_mark(5)
        log(f"phase 5 took {time.perf_counter() - t0:.1f}s")

        # 20 (a). the staleness witness's context arm on phase 5's context,
        # right after its timed runs; the rest of phase 20 runs last
        t0 = time.perf_counter()
        wa = witness_plan_cache(jp.pop("ctx"), jp["results"], rec, prec)
        witness_replays = replay_launches(rec)
        witness_preplays = replay_partition_launches(prec)
        witness_prefix_replays = replay_prefix_launches(rec)
        # (a)'s queries launch the one-hot kernel (q4, q5) and, as in phase
        # 5, no prefix sum
        check(bool(witness_replays), "phase 20 (a): no launch replayed")
        replays += witness_replays
        preplays += witness_preplays
        pl_by_phase[20] = wa["launches"]["prefix"]
        log(f"phase 20 (a) took {time.perf_counter() - t0:.1f}s")

        # 6. the rest of TPC-H, windows and percentiles
        t0 = time.perf_counter()
        rp = rest_path(data, args.warm, args.profile, rec, prec, cpu_ref)
        cpu_ref.close()
        replays += replay_launches(rec)
        preplays += replay_partition_launches(prec)
        prefix_mark(6)
        log(f"phase 6 took {time.perf_counter() - t0:.1f}s")

        # 7. grace-hash spill under a device budget; the distributed plans
        t0 = time.perf_counter()
        gp = grace_path(data, rec, prec)
        replays += replay_launches(rec)
        grace_replays = replay_partition_launches(prec)
        preplays += grace_replays
        prefix_mark(7)
        log(f"phase 7 took {time.perf_counter() - t0:.1f}s")

        # 8. the staged path: plans across the wire, shuffle files
        t0 = time.perf_counter()
        oracles = {"q1": mp["oracles"]["q1"], **{q: jp["oracles"][q] for q in ("q3", "q5", "q18")}}
        sp = staged_path(data, oracles, rec, prec)
        replays += replay_launches(rec)
        staged_replays = replay_partition_launches(prec)
        preplays += staged_replays
        prefix_mark(8)
        log(f"phase 8 took {time.perf_counter() - t0:.1f}s")

        # 9. the executor fleet: two executors over Flight, the process entry
        t0 = time.perf_counter()
        fp = fleet_path(data, oracles, sp, rec, prec, pkg_root)
        replays += replay_launches(rec)
        fleet_replays = replay_partition_launches(prec)
        preplays += fleet_replays
        prefix_mark(9)
        log(f"phase 9 took {time.perf_counter() - t0:.1f}s")

        # 10. the port's own cluster: the scheduler, standalone, the client
        t0 = time.perf_counter()
        earlier = {**mp["results"], **jp["results"], **rp["results"]}
        cp = cluster_path(
            data, oracles, fp["collect"], {q: earlier[q] for q in CLUSTER_OTHER}, fp, rec, prec, pkg_root
        )
        replays += replay_launches(rec)
        cluster_replays = replay_partition_launches(prec)
        preplays += cluster_replays
        prefix_mark(10)
        log(f"phase 10 took {time.perf_counter() - t0:.1f}s")

        # 11. file tables: Parquet, CSV and Avro through CREATE EXTERNAL TABLE
        import shutil
        import tempfile

        files_dir = pathlib.Path(tempfile.mkdtemp(prefix="chip_smoke_files-"))
        try:
            t0 = time.perf_counter()
            fl = files_path(data, oracles, earlier, files_dir, rec, prec)
            file_replays = replay_launches(rec)
            replays += file_replays
            file_preplays = replay_partition_launches(prec)
            preplays += file_preplays
            check(bool(file_replays) and bool(file_preplays), "phase 11: no launch replayed")
            prefix_mark(11)
            log(f"phase 11 took {time.perf_counter() - t0:.1f}s; {smi}")

            # 12. the operator's surface: the shell, persisted hints, the
            # capacity ladder, the system tables, REST, Prometheus, KEDA
            t0 = time.perf_counter()
            op = ops_path(data, earlier, fl.pop("results"), files_dir, rec, prec, pkg_root)
            ops_replays = replay_launches(rec)
            replays += ops_replays
            ops_preplays = replay_partition_launches(prec)
            preplays += ops_preplays
            check(bool(ops_replays) and bool(ops_preplays), "phase 12: no launch replayed")
            prefix_mark(12)
            log(f"phase 12 took {time.perf_counter() - t0:.1f}s; {smi}")
        finally:
            shutil.rmtree(files_dir, ignore_errors=True)

        # 13. adaptive query execution on the port's cluster
        t0 = time.perf_counter()
        aq = aqe_path(data, oracles, fp["collect"], rec, prec)
        aqe_replays = replay_launches(rec)
        replays += aqe_replays
        aqe_preplays = replay_partition_launches(prec)
        preplays += aqe_preplays
        check(bool(aqe_replays) and bool(aqe_preplays), "phase 13: no launch replayed")
        prefix_mark(13)
        check(pl_by_phase[13] > 0 and bool(rec.prefix_shapes.get("wrong-build-off")),
              "phase 13: SUM(v) did not launch the prefix-sum kernel")
        log(f"phase 13 took {time.perf_counter() - t0:.1f}s; {smi}")

        # 14. UDF and UDAF plugins on the card
        t0 = time.perf_counter()
        pg = plugin_path(data, rec, prec)
        plugin_replays = replay_launches(rec)
        replays += plugin_replays
        plugin_preplays = replay_partition_launches(prec)
        preplays += plugin_preplays
        prefix_replays = replay_prefix_launches(rec)
        check(bool(plugin_replays) and bool(plugin_preplays) and bool(prefix_replays),
              "phase 14: no launch replayed")
        prefix_mark(14)
        log(f"phase 14 took {time.perf_counter() - t0:.1f}s; {smi}")

        # 15. the join build-table cache and the learned flip
        t0 = time.perf_counter()
        bc = build_cache_path(data, earlier, rec, prec)
        replays += replay_launches(rec)
        preplays += replay_partition_launches(prec)
        prefix_mark(15)
        log(f"phase 15 took {time.perf_counter() - t0:.1f}s; {smi}")

        # 16. the adaptive capacity shrink and the clustered aggregate
        t0 = time.perf_counter()
        ad = adaptive_path(data, earlier, rec, prec)
        prefix_mark(16)
        adaptive_replays = replay_launches(rec)
        replays += adaptive_replays
        adaptive_preplays = replay_partition_launches(prec)
        preplays += adaptive_preplays
        adaptive_prefix_replays = replay_prefix_launches(rec)
        check(bool(adaptive_replays) and bool(adaptive_prefix_replays), "phase 16: no launch replayed")
        log(f"phase 16 took {time.perf_counter() - t0:.1f}s; {smi}")

        # 17. the static-analysis gate; the durability witness across a
        # scheduler restart
        t0 = time.perf_counter()
        started = start_gate(pkg_root)
        try:
            dp = durability_path(data, oracles, rec, prec)
        finally:
            gate = finish_gate(started)
        prefix_mark(17)
        log(f"phase 17 took {time.perf_counter() - t0:.1f}s (the gate {gate['wall_s']:.1f}s, the "
            f"restart {dp['s']:.1f}s); {smi}")

        # 18. prewarm, the executor's background prewarm, profile_dir, trace
        t0 = time.perf_counter()
        hp = hooks_path(pkg_root, data, mp["oracles"], fp["collect"]["q1"])
        # the queries' launches only: (b)'s prewarm and the q1 beside it
        # are counted apart (hp["background"])
        pl_by_phase[18] = hp["prefix_launches"]
        log(f"phase 18 took {time.perf_counter() - t0:.1f}s (the prewarm children {hp['children_s']:.1f}s); "
            f"prefix-sum launches by phase {json.dumps(pl_by_phase)}; {smi}")

        # 19. the mesh tier: the exchange, SQL on the mesh, the scheduler path
        t0 = time.perf_counter()
        mh = mesh_path(data, {"q1": mp["oracles"]["q1"], **{q: jp["oracles"][q] for q in ("q3", "q5", "q18")}},
                       rec, prec)
        mesh_replays = replay_launches(rec)
        replays += mesh_replays
        mesh_preplays = replay_partition_launches(prec)
        preplays += mesh_preplays
        mesh_prefix_replays = replay_prefix_launches(rec)
        check(bool(mesh_preplays) and bool(mesh_prefix_replays), "phase 19: no launch replayed")
        pl_by_phase[19] = mh["prefix_launches"]
        log(f"phase 19 took {time.perf_counter() - t0:.1f}s; {smi}")

        # 20 (b), (c). a witnessed cluster with an executor loss; the
        # replay property across three configurations
        t0 = time.perf_counter()
        wp = witness_path(data, oracles, fp["collect"], rec, prec)
        w_replays = replay_launches(rec)
        w_preplays = replay_partition_launches(prec)
        w_prefix_replays = replay_prefix_launches(rec)
        check(bool(w_replays) and bool(w_preplays) and bool(w_prefix_replays), "phase 20: no launch replayed")
        replays += w_replays
        preplays += w_preplays
        witness_replays += w_replays + witness_preplays + w_preplays
        witness_prefix_replays += w_prefix_replays
        pl_by_phase[20] += wp["launches"]["prefix"]
        log(f"phase 20 took {time.perf_counter() - t0:.1f}s with its replays ((a) {wa['s']:.1f}s after phase 5, "
            f"(b) {wp['cluster']['s']:.1f}s, (c) {wp['replay']['s']:.1f}s); {smi}")

        # 21. the user surface: the four examples on the card
        t0 = time.perf_counter()
        su = surface_path(pkg_root, rec, prec)
        su_replays = surface_replays(rec, prec)
        replays += su_replays["onehot"]
        preplays += su_replays["partition"]
        pl_by_phase[21] = su["launches"]["prefix"]
        log(f"phase 21 took {time.perf_counter() - t0:.1f}s with its replays ((a) "
            f"{sum(r['s'] + r['cpu_s'] for r in su['a'].values()):.1f}s, (b) "
            f"{sum(r['s'] + r['oracle_s'] for r in su['b'].values()):.1f}s); {smi}")
    prefix_launches = sum(pl_by_phase.values())
    check(prefix_launches + hp["background"]["prewarm_and_q1_launches"]["prefix"] == prefix_sum.launches,
          "prefix-sum launches: the phases do not add up")
    for q in ("q1", "wide", "q4", "q5", "q12", "q22", "q5-budget", "q1-files", f"q1-ladder-{LADDER_SPEC}",
              "q1-ladder-default"):
        check(bool(rec.shapes.get(q)), f"{q}: no kernel launch recorded")
    for q in ("q3-budget", "q5-budget", "q18-budget", "q1-dist", "q12-dist", "q3-dist",
              f"q3-ladder-dist-{LADDER_SPEC}", "q3-ladder-dist-default") + tuple(
        f"{q}-{path}" for q in STAGED_QUERIES for path in ("stages", "fleet")
    ):
        check(bool(prec.shapes.get(q)), f"{q}: no partition-hash launch recorded")
    for q in CLUSTER_QUERIES:
        for path in ("stages", "fleet", "cluster", "cluster-push"):
            if path == "cluster" or q in STAGED_QUERIES:
                check(
                    any(m == "grouped" for _, _, _, m in prec.shapes.get(f"{q}-{path}", [])),
                    f"{q}-{path}: no grouped launch recorded",
                )
    for path in ("stages", "fleet", "cluster", "cluster-push", "files-cluster"):
        check(bool(rec.shapes.get(f"q1-{path}")), f"q1-{path}: no one-hot launch recorded")
    for q in STAGED_QUERIES:
        check(
            any(m == "grouped" for _, _, _, m in prec.shapes.get(f"{q}-files-cluster", [])),
            f"{q}-files-cluster: no grouped launch recorded",
        )
    for q in STAGED_QUERIES:
        check(
            any(m == "grouped" for _, _, _, m in prec.shapes.get(f"{q}-aqe", [])),
            f"{q}-aqe: no grouped launch recorded",
        )
    for q in ("q1-aqe", "q12-aqe"):
        check(bool(rec.shapes.get(q)), f"{q}: no one-hot launch recorded")
    q1, q1_now = cases[0], cases[7]
    # the partition kernel's modes at the spills' shape (2^21 rows, one
    # int32 key, K = 64), from phase 3's timing
    ids, grouped = (
        next(r for r in ptiming if r["n"] == 1 << 21 and r["mode"] == m) for m in ("ids", "grouped")
    )
    # launches of the main path (phases 5-10): the ids and hash-only modes
    # (repartitions, hash-packed join keys) and the grouped mode (spills,
    # the shuffle writes)
    plaunches = (
        jp["partition_launches"] + rp["partition_launches"] + gp["partition_launches"]
        + sp["partition_launches"] + fp["partition_launches"] + cp["partition_launches"]
        + fl["partition_launches"] + op["partition_launches"] + aq["partition_launches"]
        + pg["partition_launches"] + bc["partition_launches"] + ad["partition_launches"]
        + dp["partition_launches"] + hp["partition_launches"] + mh["partition_launches"]
        + wa["launches"]["partition"] + wp["launches"]["partition"] + su["launches"]["partition"]
    )
    glaunches = (
        gp["grouped_launches"] + sp["grouped_launches"] + fp["grouped_launches"]
        + cp["grouped_launches"] + fl["grouped_launches"] + op["grouped_launches"]
        + aq["grouped_launches"] + pg["grouped_launches"] + bc["grouped_launches"]
        + ad["grouped_launches"] + dp["grouped_launches"] + hp["grouped_launches"]
        + mh["grouped_launches"] + wa["launches"]["grouped"] + wp["launches"]["grouped"]
        + su["launches"]["grouped"]
    )

    # 22. results
    kernels = [{
        "name": "onehot_sums",
        "route": "cuda",
        "source": "ballista_tpu_torch/csrc/onehot_agg.cu",
        "replaces": "ballista_tpu/ops/pallas_agg.py:66",
        # the paths' runs: q1, q6 and wide; q3-q18 (q4, q5 launch it); the
        # rest of TPC-H (q12, q22 and others), the window and the percentile;
        # the budgeted q3, q5, q18 and the distributed q1, q12, q3; the
        # staged q1, q3, q5, q12, q18; the same on the executor fleet and on
        # the port's cluster, with the other TPC-H queries there
        "launches": (
            mp["launches"] + jp["launches"] + rp["launches"] + gp["launches"] + sp["launches"]
            + fp["launches"] + cp["launches"] + fl["launches"] + op["launches"] + aq["launches"]
            + pg["launches"] + bc["launches"] + ad["launches"] + dp["launches"] + hp["launches"]
            + mh["launches"] + wa["launches"]["onehot"] + wp["launches"]["onehot"] + su["launches"]["onehot"]
        ),
        "max_abs_err": max(c["max_abs_err"] for c in cases + replays),
        "ms": q1["ms"],
        "device_ms": q1["device_ms"],
        "plain_ms": q1["plain_ms"],
        "bound_ms": q1["bound_ms"],
        "bound_by": q1["bound_by"],
        "library_ms": q1["library_ms"],
        "bound_share": q1["bound_ms"] / q1["ms"],
        # q1's shape now (R = 6: columns without nulls share a count row)
        "ms_at_q1_now": q1_now["ms"],
        "device_ms_at_q1_now": q1_now["device_ms"],
        "bound_ms_at_q1_now": q1_now["bound_ms"],
        "bound_share_at_q1_now": q1_now["bound_ms"] / q1_now["ms"],
    }] + [{
        "name": name,
        "route": "cuda",
        "source": "ballista_tpu_torch/csrc/partition_hash.cu",
        "replaces": "ballista_tpu/ops/partition.py:59",
        "launches": launches,
        # every comparison of phases 3 and 5-10 is bit for bit
        "max_abs_err": max([pkernel["max_abs_err"]] + [r["max_abs_err"] for r in preplays]),
        "ms": r["ms"],
        "device_ms": r["device_ms"],
        "host_us": r["host_us"],
        "plain_ms": r["plain_ms"],
        "bound_ms": r["bound_ms"],
        "bound_by": r["bound_by"],
        "library_ms": r["library_ms"],
        "bound_share": r["bound_ms"] / r["device_ms"],
        "shape": [r["n"], 1, r["K"]],
    } for name, r, launches in (
        # the ids and hash-only modes: phase 7's repartitions and the
        # hash-packed join keys of phases 5, 6, 8, 9 and 10; ids at the
        # spills' shape
        ("partition_hash", ids, plaunches - glaunches),
        # the grouped mode: every spilled batch of phase 7, every
        # hash-partitioned batch phases 8, 9 and 10 write
        ("partition_groups", grouped, glaunches),
    )]
    # the prefix-sum kernel at the largest shape the main path gave it
    # (phases 14 and 16's replays: call, plain, library and bound; device time by
    # torch.profiler), and phase 3's 6,000,000-row case
    pr = max(prefix_replays + adaptive_prefix_replays + mesh_prefix_replays + witness_prefix_replays
             + su_replays["prefix"], key=lambda r: (r["n"] * r["k"], r["n"]))
    p6m = next(c for c in pfx["cases"] if c["n"] == 6_000_000 and c["k"] == 1)
    kernels.append({
        "name": "prefix_sums",
        "route": "cuda",
        "source": "ballista_tpu_torch/csrc/prefix_sum.cu",
        "replaces": "ballista_tpu/ops/aggregate.py:403",
        "launches": prefix_launches,
        # every comparison of phases 3, 14 and 16 is bit for bit
        "max_abs_err": max(r["max_abs_err"] for r in pfx["cases"] + prefix_replays + adaptive_prefix_replays
                           + mesh_prefix_replays + witness_prefix_replays + su_replays["prefix"]),
        "ms": pr["ms"],
        "device_ms": pr["device_ms"],
        "plain_ms": pr["plain_ms"],
        "bound_ms": pr["bound_ms"],
        "bound_by": pr["bound_by"],
        "library_ms": pr["library_ms"],
        "bound_share": pr["bound_ms"] / pr["device_ms"],
        "shape": [pr["n"], pr["k"]],
        "launches_by_phase": pl_by_phase,
        "ms_at_6m": p6m["ms"], "device_ms_at_6m": p6m["device_ms"], "plain_ms_at_6m": p6m["plain_ms"],
        "library_ms_at_6m": p6m["library_ms"], "bound_ms_at_6m": p6m["bound_ms"],
        # phase 3's timed shapes: device, call and host time against the
        # bound and torch.cumsum
        "timed": [{key: c[key] for key in ("n", "k", "device_ms", "ms", "host_us", "library_ms", "bound_ms")}
                  for c in pfx["cases"] if "device_ms" in c],
    })
    log(json.dumps({
        "prefix": pfx,
        "prefix_replays": prefix_replays,
        "plugins": {k: v for k, v in pg.items()},
        "cases": cases,
        "crossover": sweep["kernel_loses_at_PR"],
        "concurrent": concurrent,
        "path_launches": replays,
        "modes": by_mode["points"],
        "sort": sorted_ok,
        "queries": {q: mp[q] for q in ("q1", "q6", "wide")},
        "peak_bytes": mp["peak_bytes"],
        "hash": hashed,
        "decimal": decimal,
        "join_queries": {q: jp[q] for q in JOIN_QUERIES},
        "join_peak_bytes": jp["peak_bytes"],
        "rest_queries": {q: rp[q] for q in REST_QUERIES + ("window", "percentile")},
        "rest_peak_bytes": rp["peak_bytes"],
        "partition_kernel": pkernel["cases"],
        "partition_groups": pgroups,
        "partition_timing": ptiming,
        "partition_launches": preplays,
        "grace_queries": {q: v for q, v in gp.items() if q.endswith(("-budget", "-dist"))},
        "grace_peak_bytes": gp["peak_bytes"],
        "dist_peak_bytes": gp["dist_peak_bytes"],
        "staged_queries": {q: v for q, v in sp.items() if q.endswith("-stages")},
        "staged_peak_bytes": sp["peak_bytes"],
        "fleet_queries": {q: v for q, v in fp.items() if q.endswith("-fleet")},
        "fleet_process": fp["process"],
        "fleet_peak_bytes": fp["peak_bytes"],
        "cluster_queries": {q: v for q, v in cp.items() if q.endswith(("-cluster", "-cluster-push", "-loss"))},
        "cluster_hists": {k: v for k, v in cp.items() if k.endswith("_hists")},
        "cluster_seconds": {k: v for k, v in cp.items() if k.endswith("_s")},
        "cluster_processes": cp["processes"],
        "cluster_peak_bytes": cp["peak_bytes"],
        "file_queries": {q: v for q, v in fl.items() if isinstance(v, dict) and q != "statements"},
        "file_seconds": {k: v for k, v in fl.items() if k.endswith("_s")},
        "file_peak_bytes": {k: v for k, v in fl.items() if k.endswith("_peak_bytes")},
        "file_launches": {"onehot": fl["launches"], "partition": fl["partition_launches"],
                          "grouped": fl["grouped_launches"]},
        "file_replays": file_replays + file_preplays,
        "ops": {k: v for k, v in op.items() if not k.endswith("launches")},
        "ops_launches": {"onehot": op["launches"], "partition": op["partition_launches"],
                         "grouped": op["grouped_launches"]},
        "ops_replays": ops_replays + ops_preplays,
        "aqe": {k: v for k, v in aq.items() if not k.endswith("launches")},
        "aqe_launches": {"onehot": aq["launches"], "partition": aq["partition_launches"],
                         "grouped": aq["grouped_launches"]},
        "aqe_replays": aqe_replays + aqe_preplays,
        "build_cache": {k: v for k, v in bc.items() if not k.endswith("launches")},
        "adaptive": {k: v for k, v in ad.items() if not k.endswith("launches")},
        "adaptive_prefix_replays": adaptive_prefix_replays,
        "analysis_gate": gate,
        "durable": {k: v for k, v in dp.items() if not k.endswith("launches")},
        "hooks": {k: v for k, v in hp.items() if not k.endswith("launches")},
        "mesh": {k: v for k, v in mh.items() if not k.endswith("launches")},
        "mesh_replays": mesh_replays + mesh_preplays + mesh_prefix_replays,
        "witness": {"plan_cache": wa, **{k: v for k, v in wp.items() if k != "launches"}},
        "witness_launches": {k: wa["launches"][k] + wp["launches"][k] for k in KERNEL_COUNTS},
        "witness_replays": witness_replays + witness_prefix_replays,
        "surface": {k: v for k, v in su.items() if k != "launches"},
        "surface_launches": su["launches"],
        "surface_replays": su_replays,
        "sf": args.sf,
    }, default=str))
    log(f"chip_smoke: phases 1-21 in {time.perf_counter() - t_main:.1f}s")
    log(json.dumps({"kernels": kernels}))
    log(smi)
    log(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name, "count": count}}))
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except SmokeFailure as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr, flush=True)
        sys.exit(1)
