"""Multi-GPU parallelism.

The reference is strictly single-GPU (int device=0, FFT-GPU-32bit.cu:15;
no MPI/NCCL/streams — SURVEY.md §2.4).  Its one parallelism axis is the
batch (grid of independent FFT blocks), which across cards maps to
sharding the leading batch axis of the input over a
torch.distributed DeviceMesh (:mod:`smfft_tpu_torch.parallel.sharding`):
embarrassingly parallel, zero collectives.

Beyond the reference, :mod:`smfft_tpu_torch.parallel.distributed`
computes ONE transform sharded along the transform axis (four-step
decomposition with all_to_all transposes over the mesh's process group)
for N up to 2**28.

Both return DTensors; :func:`smfft_tpu_torch.parallel.dryrun.
dryrun_multichip` runs them in spawned gloo ranks on the CPU.
"""

from smfft_tpu_torch.parallel.sharding import (  # noqa: F401
    batch_mesh,
    shard_batch,
    sharded_convolve,
    sharded_fft,
)
from smfft_tpu_torch.parallel.distributed import (  # noqa: F401
    distributed_fft,
    distributed_ifft,
    distributed_irfft,
    distributed_rfft,
    plan_distributed,
)
