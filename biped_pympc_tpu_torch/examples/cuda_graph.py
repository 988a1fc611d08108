"""One step of a loop over a carry, run eagerly or replayed as a CUDA graph:
`LoopStep` and `copy_into` live in `biped_pympc_tpu_torch/utils/cuda_graph.py`
(the wrapper captures its calls with them too) and are re-exported here for
the examples."""

from biped_pympc_tpu_torch.utils.cuda_graph import LoopStep, copy_into, leaves, tree_map

__all__ = ["LoopStep", "copy_into", "leaves", "tree_map"]
