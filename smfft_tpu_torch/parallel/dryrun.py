"""Run the parallel entry points in a world of spawned ranks.

Counterpart of ``__graft_entry__.dryrun_multichip`` (the JAX package's
multi-device dry run on a virtual CPU mesh), and the harness its tests
and ``chip_smoke.py`` use to drive ``parallel/`` in more than one
process:

  * :func:`spawn_world` starts ``world`` processes (the ``spawn`` start
    method: a child imports only torch and this package), joins them in a
    gloo process group through a file rendezvous in ``workdir`` (no TCP
    port, so concurrent worlds cannot collide), runs a module-level
    ``target(rank, world, *args)`` in each, and returns each rank's
    result.  A rank that raises, dies or outlives ``timeout`` fails the
    whole call: the others are killed and :class:`RuntimeError` carries
    the rank's traceback.
  * :func:`run_calls` is such a target: a list of calls of the parallel
    functions, each with its inputs, run in order in one world.  Rank 0
    returns every DTensor output gathered whole (c10d ``all_gather``);
    every rank returns its placements, local shapes, launch counts and
    (on a card) times.
  * :func:`dryrun_multichip` runs the JAX dry run's three phases in
    ``n_devices`` gloo ranks on the CPU and prints its three lines.

On a ``"cuda"`` world every rank's shards live on its card (rank modulo
the card count, as :func:`~smfft_tpu_torch.parallel.sharding.batch_mesh`
picks it): with one card every rank shares it, and gloo moves the data
between the processes.
"""

from __future__ import annotations

import datetime
import faulthandler
import os
import pickle
import statistics
import tempfile
import time
import traceback

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from smfft_tpu_torch.ops import _cuda

#: the kernels whose launches a rank counts (``ops._cuda``'s declarations)
KERNELS = tuple(_cuda.KERNELS)


def counts() -> dict:
    """Every kernel's launches in this process, by name."""
    return {name: e.count for name, e in _cuda.KERNELS.items()}


def copied_bytes() -> int:
    """The bytes the op layer has copied in this process to make its input
    rows contiguous (``ops._cuda.contiguous``)."""
    return _cuda.copied


def plane_bytes() -> int:
    """The bytes the acceleration plane's device passes have read and
    written in this process (``accel.moved``: the framing, the bank's
    convolution, the crop and the power)."""
    from smfft_tpu_torch import accel
    return accel.moved


def accel_banks() -> int:
    """The acceleration template banks built in this process
    (``accel.built``, one per zmax, dz and device)."""
    from smfft_tpu_torch import accel
    return accel.built


def column_routes() -> int:
    """The C2C transforms over a leading axis that the column route has
    run in this process, copying nothing (``ops.fourstep_fused.run_columns``,
    backward passes included)."""
    from smfft_tpu_torch.ops import fourstep_fused
    return fourstep_fused.run_columns.calls


def column_fused() -> int:
    """The column routes of this process that ran both passes of a
    two-pass column plan in one launch on a card, the fused column launch
    (``ops.fourstep_fused.run_columns.fused``)."""
    from smfft_tpu_torch.ops import fourstep_fused
    return fourstep_fused.run_columns.fused


def _rank_entry(rank: int, world: int, workdir: str, device: str,
                timeout: float) -> None:
    """One spawned rank: join the gloo group, run the target saved in
    ``workdir``, save its result (or the traceback, then re-raise).  A
    rank killed by a signal leaves its Python stack in ``rank<r>.err``."""
    # open to the process's end: faulthandler writes there on a crash in
    # the teardown too
    fault = open(os.path.join(workdir, f"rank{rank}.err"), "w")
    faulthandler.enable(file=fault)
    try:
        with open(os.path.join(workdir, "target.pkl"), "rb") as f:
            target, args = pickle.load(f)
        if device == "cpu":
            torch.set_num_threads(1)
        dist.init_process_group(
            "gloo", init_method=f"file://{workdir}/rendezvous",
            world_size=world, rank=rank,
            timeout=datetime.timedelta(seconds=timeout))
        try:
            result = target(rank, world, *args)
            dist.barrier()
        finally:
            dist.destroy_process_group()
        torch.save(result, os.path.join(workdir, f"rank{rank}.pt"))
    except BaseException:
        fault.write(traceback.format_exc())
        raise
    finally:
        fault.flush()


def spawn_world(world: int, target, args: tuple = (), *,
                workdir: str | None = None, device: str = "cpu",
                timeout: float = 300.0) -> list:
    """Run ``target(rank, world, *args)`` in ``world`` spawned gloo ranks
    and return the ranks' results in rank order.  ``target`` must be a
    module-level function of an importable module (it is pickled by
    name).  ``device`` is what the ranks' meshes use ("cpu" or "cuda");
    the CPU ranks run one thread each."""
    if device == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("a 'cuda' world needs a CUDA device")
    workdir = workdir or tempfile.mkdtemp(prefix="smfft_world_")
    os.makedirs(workdir, exist_ok=True)
    # the target and its arguments go through a file: a large pickle sent
    # with Process.start() would block each start until its child has
    # booted and read it, starting the ranks one after another
    with open(os.path.join(workdir, "target.pkl"), "wb") as f:
        pickle.dump((target, args), f)
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=_rank_entry,
                         args=(r, world, workdir, device, timeout),
                         daemon=True)
             for r in range(world)]
    for p in procs:
        p.start()
    deadline = time.monotonic() + timeout
    failed = None
    try:
        while any(p.is_alive() for p in procs):
            failed = next((r for r, p in enumerate(procs)
                           if p.exitcode not in (None, 0)), None)
            if failed is not None or time.monotonic() > deadline:
                break
            time.sleep(0.02)
        else:
            failed = next((r for r, p in enumerate(procs)
                           if p.exitcode != 0), None)
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
            p.join(timeout=30)
    if failed is None and any(p.exitcode != 0 for p in procs):
        raise RuntimeError(f"the {world}-rank world outlived its {timeout} s")
    if failed is not None:
        with open(os.path.join(workdir, f"rank{failed}.err")) as f:
            why = f.read() or "no traceback"
        raise RuntimeError(f"rank {failed} of {world} failed (exit code "
                           f"{procs[failed].exitcode}):\n{why}")
    return [torch.load(os.path.join(workdir, f"rank{r}.pt"),
                       weights_only=False) for r in range(world)]


# ---------------------------------------------------------------------------
# A list of calls, run in one world
# ---------------------------------------------------------------------------


def rand_input(shape, dtype: str, seed: int) -> np.ndarray:
    """The same input on every rank: uniform in [-0.5, 0.5), numpy's
    generator from ``seed`` (complex: real then imaginary plane)."""
    rng = np.random.default_rng(seed)
    if dtype == "complex64":
        return (rng.random(shape, dtype=np.float32) - 0.5
                + 1j * (rng.random(shape, dtype=np.float32) - 0.5)
                ).astype(np.complex64)
    return (rng.random(shape, dtype=np.float32) - 0.5).astype(dtype)


def _resolve(fn_name: str):
    from smfft_tpu_torch.parallel import distributed, sharding
    for module in (distributed, sharding):
        if hasattr(module, fn_name):
            return getattr(module, fn_name)
    raise ValueError(f"no parallel function {fn_name!r}")


def _arg(spec, mesh, axis_name: str, device: torch.device, done: dict):
    """One argument of a call:
      ndarray                     -> a plain tensor on ``device``
      ("rand", shape, dtype, seed) -> :func:`rand_input`, on ``device``
      ("ref", key)                -> the DTensor an earlier call returned
      ("refmul", key, spec)       -> that DTensor times the global array
                                     ``spec`` gives (an ndarray or a
                                     "rand" spec), block by block in its
                                     placement
      ("block", ndarray, dim)     -> this rank's block of the array
      "MESH"                      -> the call's mesh
    anything else passes as it is."""
    from smfft_tpu_torch.parallel.sharding import _block, _sharded
    if isinstance(spec, np.ndarray):
        return torch.from_numpy(spec.copy()).to(device)
    if isinstance(spec, str) and spec == "MESH":
        return mesh
    if isinstance(spec, tuple) and spec and spec[0] == "rand":
        return torch.from_numpy(rand_input(*spec[1:])).to(device)
    if isinstance(spec, tuple) and spec and spec[0] == "ref":
        return done[spec[1]]
    if isinstance(spec, tuple) and spec and spec[0] == "refmul":
        a = done[spec[1]]
        h = _arg(spec[2], mesh, axis_name, device, done)
        h = _block(h, mesh, axis_name, a.placements[0].dim)
        return _sharded(a.to_local() * h, mesh, a.placements[0])
    if isinstance(spec, tuple) and spec and spec[0] == "block":
        return _block(torch.from_numpy(spec[1].copy()), mesh, axis_name,
                      spec[2]).to(device)
    return spec


def _event_ms(fn, reps: int) -> float:
    """Median CUDA-event time of fn() over ``reps`` runs after a warm-up,
    the ranks lined up by a barrier before each run."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        dist.barrier()
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        stop.record()
        stop.synchronize()
        times.append(start.elapsed_time(stop))
    return statistics.median(times)


def run_calls(rank: int, world: int, calls: list, device: str = "cpu",
              reps: int = 0) -> dict:
    """Run ``calls`` in order on this rank (a :func:`spawn_world` target).

    Each call is a dict: ``key``, ``fn`` (a function of
    ``parallel.sharding`` / ``parallel.distributed``, private ones
    included), ``args`` (see :func:`_arg`), ``kwargs``, ``axis`` (the
    mesh axis name, default "fft"), ``raises`` (the call must raise: its
    type and text are kept) and ``time`` (on a card: the median of
    ``reps`` CUDA-event runs after the checked one).  Returns
    ``{"calls": {key: ...}, "counts": {...}}``: launches over the checked
    runs (timing runs excluded), rank 0's DTensor outputs gathered whole
    as ``full`` (numpy), every rank's plain-tensor outputs as ``local``."""
    from smfft_tpu_torch.parallel.sharding import _full, _mesh_device, \
        batch_mesh
    from torch.distributed.tensor import DTensor
    meshes, done, out = {}, {}, {}
    total = dict.fromkeys(KERNELS, 0)
    for call in calls:
        axis = call.get("axis", "fft")
        if axis not in meshes:
            meshes[axis] = batch_mesh(device, axis_name=axis)
        mesh = meshes[axis]
        dev = _mesh_device(mesh)
        fn = _resolve(call["fn"])
        args = [_arg(a, mesh, axis, dev, done) for a in call["args"]]
        kwargs = call.get("kwargs", {})
        rec = {}
        before = counts()
        if call.get("raises"):
            try:
                fn(*args, **kwargs)
            except (ValueError, KeyError, RuntimeError) as e:
                rec["error"] = (type(e).__name__, str(e))
            else:
                raise AssertionError(f"{call['key']}: no error raised")
            out[call["key"]] = rec
            continue
        y = fn(*args, **kwargs)
        if dev.type == "cuda":
            torch.cuda.synchronize()
        after = counts()
        rec["counts"] = {k: after[k] - before[k] for k in KERNELS
                         if after[k] != before[k]}
        for k in KERNELS:
            total[k] += after[k] - before[k]
        if isinstance(y, DTensor):
            done[call["key"]] = y
            rec["placements"] = [repr(p) for p in y.placements]
            rec["mesh_size"] = y.device_mesh.size()
            rec["shape"] = tuple(y.shape)
            rec["local_shape"] = tuple(y.to_local().shape)
            rec["local_device"] = y.to_local().device.type
            if call.get("gather", True):
                full = _full(y)
                if rank == 0:
                    rec["full"] = full.cpu().numpy()
                del full
        else:
            rec["local"] = y.cpu().numpy()
        if call.get("time") and reps and dev.type == "cuda":
            rec["ms"] = _event_ms(lambda: fn(*args, **kwargs), reps)
        if not call.get("keep", True):
            done.pop(call["key"], None)
        del y
        out[call["key"]] = rec
    return {"calls": out, "counts": total}


# ---------------------------------------------------------------------------
# The dry run
# ---------------------------------------------------------------------------


def _dryrun_rank(rank: int, world: int) -> list:
    """The three phases of ``__graft_entry__.dryrun_multichip`` on one
    rank; returns the lines rank 0 prints."""
    from smfft_tpu_torch import api
    from smfft_tpu_torch.parallel import (batch_mesh, distributed_irfft,
                                          distributed_rfft, sharded_fft)
    from smfft_tpu_torch.parallel.sharding import _sharded
    from torch.distributed.tensor import Shard

    mesh = batch_mesh("cpu")
    n, batch = 256, 8 * world
    rng = np.random.default_rng(0)
    vr = torch.from_numpy(rng.random((batch, n), dtype=np.float32) - 0.5)
    vi = torch.from_numpy(rng.random((batch, n), dtype=np.float32) - 0.5)
    h = torch.from_numpy(rng.random((1, n), dtype=np.float32))
    lines = []

    # phase 1: the batch-sharded step fft -> * h -> ifft
    spec = sharded_fft(torch.complex(vr, vi), mesh)
    filtered = _sharded(spec.to_local() * h, mesh, Shard(0))
    out = sharded_fft(filtered, mesh, inverse=True)
    assert out.shape == (batch, n)
    assert out.device_mesh.size() == world
    lines.append(f"dryrun_multichip({world}): step ran; output sharded over "
                 f"{out.device_mesh.size()} devices")

    # phase 2: the relayout-free round trip through the kernel route (the
    # plain versions on the CPU) on each rank's rows: n * x
    c = batch // world
    rows = slice(rank * c, (rank + 1) * c)
    x = torch.complex(vr[rows], vi[rows])
    back = api.ifft_unordered(api.fft(x, ordered=False), norm=None)
    err = torch.tensor(float((back.real / n - vr[rows]).abs().max()))
    dist.all_reduce(err, op=dist.ReduceOp.MAX)
    assert err.item() < 1e-4, f"kernel-route SPMD roundtrip err {err}"
    lines.append(f"dryrun_multichip({world}): kernel route ran on each "
                 f"rank's rows on {world} devices (roundtrip err "
                 f"{err.item():.2e})")

    # phase 3: the batched distributed real transform round trip
    fft_mesh = batch_mesh("cpu", axis_name="fft")
    nd = 1 << 16
    xb = torch.from_numpy(rng.random((2, nd), dtype=np.float32) - 0.5)
    hs = distributed_rfft(xb, fft_mesh)
    assert hs.shape == (2, nd // 2)
    assert hs.device_mesh.size() == world
    back = distributed_irfft(hs, fft_mesh, normalize=True).full_tensor()
    rerr = float((back - xb).abs().max())
    assert rerr < 1e-4, f"distributed rfft roundtrip err {rerr}"
    lines.append(f"dryrun_multichip({world}): batched distributed rfft "
                 f"round trip over the {world}-device mesh (err "
                 f"{rerr:.2e})")
    return lines


def dryrun_multichip(n_devices: int, workdir: str | None = None) -> list:
    """Run the batch-sharded step, the relayout-free round trip and the
    distributed real round trip in ``n_devices`` gloo ranks on the CPU,
    print the three lines and return them."""
    lines = spawn_world(n_devices, _dryrun_rank, workdir=workdir)[0]
    for line in lines:
        print(line)
    return lines
