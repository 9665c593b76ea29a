"""Expression layer: the logical AST (a copy of the reference's) and its
compilation to torch evaluators (:mod:`ballista_tpu_torch.expr.physical`,
imported on its own so this package stays device-free)."""
