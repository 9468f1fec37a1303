"""Distribution layer: mesh sharding, four-step large-N FFT, halo streams.

Counterpart of ``pffft_tpu/parallel``, on ``torch.distributed``.  PFFFT is
single-node (its parallelism is 4-lane SIMD plus read-only plan
shareability); this package is the scaling story that replaces those
axes:

  * batch/channel sharding (the DP analog)  -> :mod:`.mesh`
  * four-step (Bailey) large-N single FFT with all-to-all transposes
    (the TP/SP analog)                      -> :mod:`.fourstep`
  * overlap-save halo exchange by send/recv (the CP analog)
                                             -> :mod:`.stream`
  * the pencil-decomposed 2-D FFT           -> :mod:`.pencil`

All entry points take an explicit ``DeviceMesh`` (:func:`make_mesh`) over
a process group the caller started; nothing here starts one or spawns
processes.  On a single rank no collective runs and everything degrades
to the local engine.
"""

from .fourstep import FourStepPlan, fourstep_cfft, fourstep_icfft, fourstep_irfft, fourstep_rfft
from .mesh import batch_sharding, make_mesh, shard_batch
from .pencil import Pencil2D
from .stream import halo_exchange_right, sharded_fastconv_valid

__all__ = [
    "make_mesh",
    "batch_sharding",
    "shard_batch",
    "FourStepPlan",
    "fourstep_cfft",
    "fourstep_icfft",
    "fourstep_rfft",
    "fourstep_irfft",
    "sharded_fastconv_valid",
    "halo_exchange_right",
    "Pencil2D",
]
