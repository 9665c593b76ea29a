"""Client layer: the distributed ``BallistaContext`` (``context``) and the
Arrow Flight data-plane client (``flight``), ports of
``ballista_tpu/client``.

``BallistaContext.standalone(device="cuda")`` boots an in-process
scheduler and executors; ``BallistaContext.remote(host, port,
device="cuda")`` opens a session on a running scheduler. Re-exports are
lazy (module ``__getattr__``): the executor's data plane imports
``client.flight`` for shuffle fetches and must not drag the whole
client-context stack (grpc, SQL parser/planner, scheduler RPC stubs) into
its hot path.
"""

__all__ = ["BallistaContext", "fetch_partition"]


def __getattr__(name: str):
    if name == "BallistaContext":
        from ballista_tpu_torch.client.context import BallistaContext

        return BallistaContext
    if name == "fetch_partition":
        from ballista_tpu_torch.client.flight import fetch_partition

        return fetch_partition
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
