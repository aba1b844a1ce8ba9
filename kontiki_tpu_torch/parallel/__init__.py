"""Scale-out layouts (counterpart of ``kontiki_tpu.parallel``).

Ported: ``segments_ba``, the knot-segment x landmark-block layout of
BASELINE config 5 with its banded direct solve and its matrix-free PCG
mode, on one shard. The JAX
package's measurement sharding, its other layouts and every multi-shard
path wait for ``torch.distributed`` (ROADMAP.md Queue A 5).
"""
from .segments_ba import make_segment_ba_solver, make_segment_ba_step, segment_ba_layout

__all__ = ["make_segment_ba_step", "make_segment_ba_solver", "segment_ba_layout"]
