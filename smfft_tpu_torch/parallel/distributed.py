"""Distributed single-transform FFT over the ranks of a device mesh.

Counterpart of ``smfft_tpu/parallel/distributed.py``.  ``sharding.py``
scales the reference's one parallel axis, the batch, with no collective.
This module computes ONE transform whose length exceeds a single card's
kernel (or memory) across the mesh with the four-step decomposition
(``ops/fourstep.py``), where the inter-stage transposes are
``torch.distributed.all_to_all_single`` exchanges on the mesh axis's
process group:

    global A (N1, N2), columns sharded          local (N1, N2/d)
    stage 1: row FFT_N1 of A^T (local)          local (N2/d, N1)
    twiddle W_N^(n2*k1) (local, exact)          n2 offset = rank's index
    ALL-TO-ALL: reshard rows->cols              local (N1/d, N2) = C^T rows
    stage 2: row FFT_N2 (local)                 local (N1/d, N2)
    [natural order: ALL-TO-ALL + transpose]     local (N2/d, N1)

With ``transposed_output=True`` the final exchange is skipped and the
result is the (N1, N2) matrix C with C[k1, k2] = X[k2*N1 + k1], k1
sharded — the FFTW MPI ``FFTW_MPI_TRANSPOSED_OUT`` contract.  The inverse
accepts that matrix directly (``transposed_input=True``): its local
transpose is exactly the column-sharded four-step input of the inverse
with swapped factors (X.reshape(N2, N1) = C^T), so the same body runs
with no extra communication — a spectral round trip (forward, pointwise
multiply in C-layout, inverse) pays 3 exchanges instead of 4.

Every local stage is ``api.fft`` / ``api.ifft`` over the rank's rows: one
``c2c_kernel`` launch on a card, the plain version on the CPU.  The
arrays are :class:`~torch.distributed.tensor.DTensor`s: a natural-order
vector (..., N) is ``Shard(-1)`` in contiguous blocks of N/d, the C-matrix
(..., N1, N2) is ``Shard(-2)``.  A plain tensor given as input is the same
global value on every rank, and each rank takes its block with no
communication; a DTensor input in contiguous blocks costs one exchange
more (the reshard to columns), as JAX's ``device_put`` does.

The exchanges run on any backend (NCCL across cards, gloo between
processes on the CPU or on one card); a mesh of one rank calls every
collective all the same.
"""

from __future__ import annotations

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import DTensor, Shard

from smfft_tpu_torch.ops import fourstep
from smfft_tpu_torch.parallel.sharding import (_block, _mesh_size, _rank,
                                               _sharded)


def plan_distributed(n: int, d: int) -> tuple[int, int]:
    """N = N1 * N2 with both factors supported row sizes divisible by the
    mesh size d (each shard must hold whole rows/columns)."""
    n1, n2 = fourstep.split_factors(n)
    if n1 % d or n2 % d:
        raise ValueError(
            f"Error wrong FFT length! N={n} = {n1}*{n2} is not divisible "
            f"by a {d}-device mesh (need d | {n2}); use a smaller mesh or "
            f"a larger N")
    return n1, n2


def _all_to_all(b: torch.Tensor, mesh: DeviceMesh, axis_name: str, *,
                swap: bool = False) -> torch.Tensor:
    """``lax.all_to_all(b, split_axis=2, concat_axis=1, tiled=True)`` on
    the mesh axis: (B, R/d, C) blocks -> (B, R, C/d), or with ``swap`` its
    last two axes swapped, (B, C/d, R), in the same copy.

    Index map, on rank r, with b_s rank s's block and c = C/d:
        out[:, s*(R/d) + i, j] = b_s[:, i, r*c + j]
    Rank s sends its column block j to rank j and rank r concatenates
    what it receives in rank order.  ``all_to_all_single`` splits dim 0,
    so the blocks go out as (d, B, R/d, c): one permuting copy before
    the exchange and one after (which also does the swap)."""
    d = _mesh_size(mesh, axis_name)
    nb, r, c = b.shape
    send = b.reshape(nb, r, d, c // d).permute(2, 0, 1, 3).contiguous()
    recv = torch.empty_like(send)
    dist.all_to_all_single(recv, send, group=mesh.get_group(axis_name))
    if swap:   # (d, B, R/d, c) -> (B, c, d, R/d)
        return recv.permute(1, 3, 0, 2).reshape(nb, c // d, d * r)
    return recv.permute(1, 0, 2, 3).reshape(nb, d * r, c // d)


def _row_fft(x: torch.Tensor, inverse: bool, backend: str,
             precision: str | None, norm: str | None) -> torch.Tensor:
    """Ordered row transform: one C2C launch on a card."""
    from smfft_tpu_torch import api
    if inverse:
        return api.ifft(x, backend=backend, precision=precision, norm=norm)
    return api.fft(x, backend=backend, precision=precision)


def _local_four_step(a_loc: torch.Tensor, *, n: int, n1: int, n2: int,
                     d: int, inverse: bool, pre_transpose: bool,
                     transposed_out: bool, backend: str,
                     precision: str | None, axis_name: str,
                     mesh: DeviceMesh, norm: str | None) -> torch.Tensor:
    """Per-rank four-step body.

    ``a_loc`` is (B, n1, n2/d) — this rank's column block of the
    (B, n1, n2) input matrices — or, with ``pre_transpose``, the
    (B, n2/d, n1) local block of its distributed transpose (the
    transposed-output C-matrix of a prior forward, whose local transpose
    IS the column-sharded input of the inverse with swapped factors).
    An inverse's "backward" norm divides each stage by its row length,
    1/N in all, inside the kernels.
    """
    rows = a_loc if pre_transpose else a_loc.transpose(-1, -2)
    # stage 1: FFT over n1 (length n1) at this rank's n2-column block
    b = _row_fft(rows, inverse, backend, precision, norm)  # (B, n2/d, n1)
    off = _rank(mesh, axis_name) * (n2 // d)
    n2_global = off + torch.arange(n2 // d, device=b.device)
    b = fourstep.twiddle_rows(b, n2_global, n, inverse)
    # reshard rows->cols: (B, n2/d, n1) -> (B, n2, n1/d), taken transposed
    c = _all_to_all(b, mesh, axis_name, swap=True)         # (B, n1/d, n2)
    # stage 2: FFT over n2 (length n2) at this rank's k1-row block
    out = _row_fft(c, inverse, backend, precision, norm)   # (B, n1/d, n2)
    if transposed_out:
        return out  # C[k1, k2] row block: X[k2*n1 + k1]
    # natural order: reshard back, transposed -> X.reshape(n2, n1) block
    return _all_to_all(out, mesh, axis_name, swap=True)    # (B, n2/d, n1)


def _dist_c2c(x: torch.Tensor, mesh: DeviceMesh, *, inverse: bool,
              transposed_input: bool, transposed_output: bool,
              backend: str, precision: str | None, norm: str | None,
              axis_name: str) -> DTensor:
    """Batched distributed C2C core: x is (..., N) (any leading batch
    dims, including none), or the (..., N1, N2) C-matrix with
    ``transposed_input``.  ``norm`` is "backward" or None (an inverse's;
    the JAX package reads any other as None: ROADMAP C.3)."""
    d = _mesh_size(mesh, axis_name)
    if norm not in ("backward", None):
        raise ValueError(f"norm must be 'backward' or None, got {norm!r}")
    if transposed_input:
        if transposed_output:
            raise ValueError("transposed_input with transposed_output "
                             "is not supported; the round-trip contract "
                             "is forward(transposed_output=True) -> "
                             "inverse(transposed_input=True) -> natural")
        if x.dim() < 2:
            raise ValueError("transposed_input expects the (..., N1, N2) "
                             "C-matrix a transposed-output forward "
                             "returned")
        batch = tuple(x.shape[:-2])
        fn1, fn2 = x.shape[-2:]       # forward factors
        n = fn1 * fn2
        if (fn1, fn2) != plan_distributed(n, d):
            raise ValueError(
                f"unexpected transposed shape {tuple(x.shape[-2:])}; "
                f"expected {plan_distributed(n, d)}")
        # C^T = X.reshape(fn2, fn1): the inverse runs the standard body
        # with swapped factors; the k1-row block is already the body's
        # transposed input (pre_transpose).
        n1, n2 = fn2, fn1
        a = _block(x, mesh, axis_name, x.dim() - 2).reshape(-1, fn1 // d,
                                                             fn2)
        pre = True
    else:
        batch = tuple(x.shape[:-1])
        n = x.shape[-1]
        n1, n2 = plan_distributed(n, d)
        if isinstance(x, DTensor):
            # contiguous blocks = row blocks of A: one exchange to columns
            rows = _block(x, mesh, axis_name, -1).reshape(-1, n1 // d, n2)
            a, pre = _all_to_all(rows, mesh, axis_name, swap=True), True
        else:
            a = _block(x.reshape(-1, n1, n2), mesh, axis_name, 2)
            pre = False
    out = _local_four_step(
        a, n=n, n1=n1, n2=n2, d=d, inverse=inverse, pre_transpose=pre,
        transposed_out=transposed_output, backend=backend,
        precision=precision, axis_name=axis_name, mesh=mesh,
        norm=norm if inverse else None)
    if transposed_output:
        # (..., n1, n2) C-matrix, k1 sharded
        return _sharded(out.reshape(batch + (n1 // d, n2)), mesh,
                        Shard(len(batch)))
    # natural order, sharded blocks
    return _sharded(out.reshape(batch + (n // d,)), mesh, Shard(len(batch)))


def distributed_fft(x: torch.Tensor, mesh: DeviceMesh, *,
                    transposed_output: bool = False,
                    backend: str = "auto", precision: str | None = None,
                    axis_name: str = "fft") -> DTensor:
    """Forward C2C FFT of huge vectors, each sharded over the mesh.

    Args:
      x: complex64 (..., N) — one vector or a batch (every transform is
        mesh-distributed; shard the batch with parallel.sharding instead
        when transforms fit one card) — a plain tensor holding the same
        global value on every rank, or a DTensor.  N = N1*N2 a power of
        two with both balanced factors supported row sizes divisible by
        the mesh size (N in [1024, 2**28] for mesh sizes up to 32).
      transposed_output: skip the final exchange and return the (N1, N2)
        matrix C with C[k1, k2] = X[k2*N1 + k1], k1 sharded
        (FFTW_MPI_TRANSPOSED_OUT); feed it back via
        ``distributed_ifft(..., transposed_input=True)``.

    Returns the natural-order spectrum (..., N) as a DTensor sharded in
    contiguous blocks (``Shard(-1)``) unless ``transposed_output``.
    """
    return _dist_c2c(x, mesh, inverse=False, transposed_input=False,
                     transposed_output=transposed_output, backend=backend,
                     precision=precision, norm=None, axis_name=axis_name)


def distributed_ifft(x: torch.Tensor, mesh: DeviceMesh, *,
                     transposed_input: bool = False,
                     norm: str | None = "backward",
                     backend: str = "auto", precision: str | None = None,
                     axis_name: str = "fft") -> DTensor:
    """Inverse of :func:`distributed_fft`, returning natural-order time
    samples (..., N).

    With ``transposed_input=True`` x is the (..., N1, N2) C-matrix a
    transposed-output forward returned (k1 sharded); the inverse consumes
    it with no extra communication (local transpose + swapped factors).
    ``norm="backward"`` divides by N; ``norm=None`` keeps the reference's
    raw unnormalized inverse (SURVEY.md quirk 3); any other raises.
    """
    return _dist_c2c(x, mesh, inverse=True,
                     transposed_input=transposed_input,
                     transposed_output=False, backend=backend,
                     precision=precision, norm=norm, axis_name=axis_name)


# ---------------------------------------------------------------------------
# distributed real transforms: the reference pack trick
# (SMFFT_Stockham_R2C_C2R/FFT-GPU-32bit-Stockham.cu:269-344) at mesh scale
# ---------------------------------------------------------------------------

def _mirror_shards(z: torch.Tensor, d: int, axis_name: str, *,
                   mesh: DeviceMesh) -> torch.Tensor:
    """Zrev[..., k] = Z[..., (L - k) % L] on block-sharded rows: local
    flip, the whole flipped block to rank d-1-s (``all_to_all_single``
    with every split empty but that one: JAX's first ppermute), then the
    one-element cyclic shift for the (L - k) offset (an ``all_gather`` of
    each rank's last element: the second ppermute).  Two small exchanges
    a call, on any backend and at any d (at d = 1 both move the data to
    the same rank)."""
    group = mesh.get_group(axis_name)
    s = _rank(mesh, axis_name)
    zf = torch.flip(z, dims=(-1,)).contiguous()
    # rank s's flipped block belongs at position d-1-s of the global
    # flip; after this exchange rank t holds Zflip[t*c : (t+1)*c] with
    # Zflip[j] = Z[L-1-j]
    splits = [0] * d
    splits[d - 1 - s] = zf.numel()
    moved = torch.empty_like(zf)
    dist.all_to_all_single(moved.view(-1), zf.view(-1), splits, splits,
                           group=group)
    # Zrev[k] = Zflip[(k - 1) mod L]: shift right by one across the
    # shard boundary (cyclic — rank 0's first element is Z[0])
    last = moved[..., -1:].contiguous()
    lasts = [torch.empty_like(last) for _ in range(d)]
    dist.all_gather(lasts, last, group=group)
    return torch.cat([lasts[(s - 1) % d], moved[..., :-1]], dim=-1)


def _wk_block(n: int, L: int, d: int, inverse: bool, axis_name: str, *,
              mesh: DeviceMesh, device: torch.device) -> torch.Tensor:
    """complex64 (c,) W_N^k for this rank's global k block, assembled from
    the exact hi/lo split tables (``fourstep.roots``)."""
    c = L // d
    k = _rank(mesh, axis_name) * c + torch.arange(c, device=device)
    return fourstep.roots(k, n, inverse, torch.complex64)


def _split_body(z: torch.Tensor, *, n: int, L: int, d: int,
                axis_name: str, mesh: DeviceMesh) -> torch.Tensor:
    """Forward Hermitian split on a rank's block: Z = FFT_L(packed x) ->
    packed half-spectrum X (slot 0 = DC + i*Nyq on rank 0).
    X = E + W O, E = (Z + conj M) / 2, O = -i (Z - conj M) / 2, M the
    mirror Z[(L - k) % L]."""
    zm = _mirror_shards(z, d, axis_name, mesh=mesh).conj()
    w = _wk_block(n, L, d, False, axis_name, mesh=mesh, device=z.device)
    x = 0.5 * (z + zm) - 0.5j * w * (z - zm)
    if _rank(mesh, axis_name) == 0:
        # slot 0 on rank 0: DC + i*Nyq (reference packed layout)
        zr, zi = z[..., 0].real, z[..., 0].imag
        x[..., 0] = torch.complex(zr + zi, zr - zi)
    return x


def _merge_body(h: torch.Tensor, *, n: int, L: int, d: int,
                axis_name: str, mesh: DeviceMesh) -> torch.Tensor:
    """Inverse merge on a rank's block: packed half-spectrum -> the
    pre-processed z whose inverse FFT_L is the packed signal.
    z = E + i W T, E = (X + conj M) / 2, T = (X - conj M) / 2, with X[0] =
    DC and M[0] = Nyq (both real) from rank 0's slot 0."""
    first = _rank(mesh, axis_name) == 0
    x = h.clone()
    if first:
        x[..., 0] = h[..., 0].real.to(h.dtype)
    m = _mirror_shards(x, d, axis_name, mesh=mesh)
    if first:
        m[..., 0] = h[..., 0].imag.to(h.dtype)
    m = m.conj()
    w = _wk_block(n, L, d, True, axis_name, mesh=mesh, device=h.device)
    return 0.5 * (x + m) + 0.5j * w * (x - m)


def distributed_rfft(x: torch.Tensor, mesh: DeviceMesh, *,
                     backend: str = "auto", precision: str | None = None,
                     axis_name: str = "fft") -> DTensor:
    """Distributed R2C via the reference pack trick: real (..., N) ->
    packed complex half-spectrum (..., N/2), slot 0 = DC + i*Nyquist,
    natural order, block-sharded over the mesh (``Shard(-1)``).  Costs one
    distributed C2C of length N/2 plus the two small exchanges of the
    mirror.

    Reference anchor: SMFFT_Stockham_R2C_C2R packs two real points per
    complex slot (FFT-GPU-32bit-Stockham.cu:269-344); here the split
    runs as a sharded epilogue with exact W_N^k tables."""
    n = x.shape[-1]
    fourstep._check_real_n(n)
    L = n // 2
    d = _mesh_size(mesh, axis_name)
    batch = tuple(x.shape[:-1])
    if isinstance(x, DTensor):
        xl = _block(x, mesh, axis_name, -1).to(torch.float32)
        z = _sharded(torch.complex(xl[..., 0::2], xl[..., 1::2]), mesh,
                     Shard(len(batch)))
    else:
        xf = x.to(torch.float32)
        z = torch.complex(xf[..., 0::2], xf[..., 1::2])
    zf = _dist_c2c(z, mesh, inverse=False, transposed_input=False,
                   transposed_output=False, backend=backend,
                   precision=precision, norm=None, axis_name=axis_name)
    out = _split_body(zf.to_local(), n=n, L=L, d=d, axis_name=axis_name,
                      mesh=mesh)
    return _sharded(out, mesh, Shard(len(batch)))


def distributed_irfft(h: torch.Tensor, mesh: DeviceMesh, *,
                      normalize: bool = True, backend: str = "auto",
                      precision: str | None = None,
                      axis_name: str = "fft") -> DTensor:
    """Inverse of :func:`distributed_rfft`: packed half-spectrum
    (..., N/2) -> real (..., N), block-sharded.  ``normalize`` divides by
    N/2 (the numpy-parity signal); ``normalize=False`` keeps the
    reference's raw (N/2)-scale (SMFFT_Stockham_R2C_C2R/FFT.c:170-171)."""
    L = h.shape[-1]
    n = 2 * L
    fourstep._check_real_n(n)
    d = _mesh_size(mesh, axis_name)
    batch = tuple(h.shape[:-1])
    hl = _block(h, mesh, axis_name, -1).to(torch.complex64)
    z = _merge_body(hl, n=n, L=L, d=d, axis_name=axis_name, mesh=mesh)
    zi = _dist_c2c(_sharded(z, mesh, Shard(len(batch))), mesh, inverse=True,
                   transposed_input=False, transposed_output=False,
                   backend=backend, precision=precision,
                   norm="backward" if normalize else None,
                   axis_name=axis_name)
    out = torch.view_as_real(zi.to_local()).reshape(batch + (n // d,))
    return _sharded(out, mesh, Shard(len(batch)))
