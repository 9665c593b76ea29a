"""Physical operators, the physical planner and the ``TorchContext``."""
