"""Multi-device sharding: device meshes and distributed PHY pipelines.

Counterpart of the JAX package's ``parallel/``: subframe batches ride a
data-parallel mesh axis (the analog of the reference's worker pipeline,
thread_pool.h:46), component carriers ride a carrier axis (the analog of
one process per cell, radio_multi.cc), processes ride a host axis, and
the turbo decoder's trellis can be sequence-sharded with the boundary
metrics (NII) or the overlap halos exchanged between ring neighbours —
the analog of turbodecoder_win.h's lane-overlap scheme across devices.
Within one process the shards of a mesh run in turn on their devices
(several may share one card); across processes the collectives go
through ``torch.distributed`` (``parallel/comm.py``).
"""

from .dist import init_distributed, make_global_mesh
from .mesh import make_mesh, shard_batch
from .turbo_sp import sp_turbo_decode, sp_turbo_decode_nii

__all__ = ["init_distributed", "make_global_mesh", "make_mesh",
           "shard_batch", "sp_turbo_decode", "sp_turbo_decode_nii"]
