"""Huge-N C2C FFT as passes of one Hopper kernel, its wrapper, its plain
version, and the routing behind ``planar.fft_large`` / ``api.fft_large``.

Counterpart of ``smfft_tpu/ops/fourstep_fused.py`` (B22/B23) and, through
:func:`run_passes`, of the passes of ``ops/rowfour.py`` (B17) and
``ops/hugefft.py`` (B18-B21).  N = R1 * R2 * ... * Rp, each radix a power
of two in [16, 2048]; one launch of ``csrc/fourstep.cu``
(``fourstep_pass_kernel``) does every R-point transform of one factor,
for every row:

  * the default plan (:func:`plan`) is p - 1 in-place column passes (pass
    i reads and writes the R_i points of stride S = R_{i+1}...R_p, with the
    twiddle W_(R_i S)^(s k); the first also takes the scale) and a last
    pass that reads contiguous rows in digit-reversed order and writes
    columns of stride N / R_p: natural-order output;
  * the JAX package's strided two-pass (:func:`factors_plan`, B22/B23):
    pass 1 reads columns of stride n2, twiddles by W_N^(t2 k1) and writes
    the rows of Bmat (n2, n1); pass 2 reads and writes columns of stride n1;
  * the column route (:func:`column_plan`, :func:`run_columns`): a C2C over
    an axis of M <= 16384 points at a power-of-two stride K of a contiguous
    tensor, viewed (B, M K), as one or two column passes at the axis's
    stride, so the N-D transforms need no transposing copy (``ndim.py``);
    the two passes in one launch where the shape allows, which hands each
    slab of columns from the one to the other through the card's L2.

A pass is described by a :class:`Pass`: its radix, the index map of its
input and of its output (``("col", S)`` or ``("rows", radices)``), the
twiddle's column count (0: none), whether the scale applies there, and its
epilogue: ``split="pair"`` on a plan's last pass (:func:`pair_split_plan`)
writes the pair split of the real transforms (``ops/real_fused.py``)
straight from the pass's outputs, the packed half-spectra in place of the
pass's output.  A pass may carry the plan's next one (``then``): the fused
tail (:func:`tail_plan`), pass 2 and the split pass of a three-pass
pair-mode plan in one launch, which hands each block group from the one to
the other through the card's L2, and the fused column launch
(:func:`column_plan`).  The passes exchange complex64
intermediates, complex128 for the "exact" tier, so that tier's only fp32
rounding is the output's.

Dispatch is by the tensor's device: a CUDA tensor launches the kernel once
per pass (:func:`launch_pass`, counted) or raises; a CPU tensor runs
:func:`passes_plain`, the same maps, ``c2c_plain`` transforms and the same
hi/lo twiddles in plain PyTorch, never ``torch.fft``.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, replace
from functools import lru_cache, partial

import torch

from smfft_tpu_torch import params as P
from smfft_tpu_torch import trace as _T
from smfft_tpu_torch.ops import _cuda
from smfft_tpu_torch.ops import c2c as C
from smfft_tpu_torch.ops import fourstep as FS

MIN_RADIX, MAX_RADIX = 16, 2048

#: The largest last radix that takes the pair split as its epilogue
#: (``csrc/fourstep.cu`` SplitTile: two buffers of twice the plain pass's
#: transforms fit to 256).  Above it a tile holds 4-8 adjacent transforms a
#: side, and its 32-64-byte runs wrote slower than the plain pass and
#: ``real_huge_kernel``'s split together (on an H100, 2^28 samples a call:
#: 4.0 against 3.2 ms at n = 2^20, 4.6 against 4.2 at 2^27).
SPLIT_MAX_RADIX = 256

#: The fused tail's radix, pass 2's and pass 3's
#: (``fourstep_pass_kernel<128, 128, false, true, true>``): a block of
#: N/R1 = 2^14 points (128 KiB) and a group pair of 8 MiB at every N, pass
#: 1 taking radix N / 2^14.  The tail keeps three pairs in L2 at once
#: (read, written, waiting: ``csrc/fourstep.cu`` LAG = 2), 24 MiB of the
#: H100's 50 MB.  There the tail of the default (256, 256, 128) plan, 16
#: MiB pairs, broke even at 2^23 where (512, 128, 128) gained (PERF.md).
TAIL_RADIX = 128

#: The largest pass-1 radix of a fused plan: N = 2^21 .. 2^24.  At 2^25
#: pass 1 of radix 2048 (one tile buffer) lost more than the tail saved.
TAIL_FIRST_MAX = 1024

#: The radix pairs of the fused column launch
#: (``fourstep_pass_kernel<RA, RB, false, false>``, ColTile): the
#: two-pass column plans of M = 4096, 8192 and 16384.
COLUMN_PAIRS = ((64, 64), (128, 64), (128, 128))


def column_slab(r1: int, r2: int) -> int:
    """The fused column launch's slab width W at radices (r1, r2): the
    columns of its wider item (4096 / R transforms an item)."""
    return 4096 // min(r1, r2)


@dataclass(frozen=True)
class Pass:
    """One launch: ``radix``-point transforms read through ``src`` and
    written through ``dst`` (``("col", S)``: the points of transform c =
    o*S + s at o*R*S + s + j*S; ``("rows", (R1, ..., Rq))``: the contiguous
    row ((d1*R2 + d2)*R3 + ...) for c = d1 + R1*(d2 + R2*...)), each output
    point k times W_(R*tw_s)^(s*k) when tw_s, s = c mod tw_s with its low
    log2 ``tw_lo`` bits cleared (:func:`column_plan`), the input times the
    scale when ``scaled``.  ``split="pair"``: the output Z (B, N) of two
    real rows a complex row goes on as their packed half-spectra, rows b
    and b + B (``real_fused.pair_split_plain``), in place of Z.  ``then``:
    the plan's next pass, run by the same launch (:func:`tail_plan`, or
    without a split :func:`column_plan`'s fused column launch)."""
    radix: int
    src: tuple
    dst: tuple
    tw_s: int
    scaled: bool
    split: str | None = None
    then: Pass | None = None
    tw_lo: int = 1


def radices(n: int, passes: int) -> tuple[int, ...]:
    """N split into ``passes`` power-of-two radices, as even as possible,
    the larger ones first; each must lie in [16, 2048]."""
    k = n.bit_length() - 1
    base, rem = divmod(k, passes)
    rs = tuple(1 << (base + (i < rem)) for i in range(passes))
    if n != 1 << k or not all(MIN_RADIX <= r <= MAX_RADIX for r in rs):
        raise ValueError(f"Error wrong FFT length! N={n} does not split into "
                         f"{passes} passes of {MIN_RADIX}..{MAX_RADIX} points")
    return rs


def plan(rs: tuple[int, ...]) -> tuple[Pass, ...]:
    """The default p-pass plan over radices rs: column passes (DIF), then
    the digit-reversed row pass that lands natural order."""
    n = math.prod(rs)
    out = []
    for i, r in enumerate(rs[:-1]):
        s = math.prod(rs[i + 1:])
        out.append(Pass(r, ("col", s), ("col", s), s, i == 0))
    out.append(Pass(rs[-1], ("rows", tuple(rs[:-1])), ("col", n // rs[-1]),
                    0, len(rs) == 1))
    return tuple(out)


def pair_split_plan(n: int) -> tuple[Pass, ...]:
    """The forward pair-mode R2C's plan at N (real rows of N samples, two a
    complex row): :func:`default_passes` with the pair split in the last
    pass where its radix is at most :data:`SPLIT_MAX_RADIX`, else as it is
    (the split a launch of its own, ``real_fused``)."""
    passes = default_passes(n)
    if passes[-1].radix > SPLIT_MAX_RADIX:
        return passes
    return passes[:-1] + (replace(passes[-1], split="pair"),)


@lru_cache(maxsize=None)
def tail_plan(n: int, passes: tuple[Pass, ...],
              exact: bool = False) -> tuple[Pass, ...]:
    """The launches that compute ``passes`` where the shape says the fused
    tail fits, else ``passes`` as they are.  It fits the fp32 three-pass
    plan of :func:`pair_split_plan` where N / 128^2 is a pass-1 radix to
    :data:`TAIL_FIRST_MAX`: pass 1 of radix N / 128^2, then one launch of
    pass 2 carrying the split pass (radix 128 both)."""
    rs = (n // TAIL_RADIX ** 2, TAIL_RADIX, TAIL_RADIX)
    if (exact or len(passes) != 3 or passes != pair_split_plan(n)
            or not MIN_RADIX <= rs[0] <= TAIL_FIRST_MAX):
        return passes
    three = plan(rs)
    return (three[0],
            replace(three[1], then=replace(three[2], split="pair")))


def _check_tail(n: int, p: Pass) -> None:
    """The fused tail: a column pass of stride R3 with its twiddle, in
    place, then the split pass of radix R3 over the rows (N / (R2 R3),
    R2)."""
    t = p.then
    r2, r3 = p.radix, t.radix
    if (p.split or t.then or t.split != "pair" or p.src != ("col", r3)
            or p.dst != p.src or p.tw_s != r3 or p.scaled
            or t.src != ("rows", (n // (r2 * r3), r2))):
        raise ValueError("the fused tail is a column pass of stride R3 and "
                         f"then the plan's split pass of radix R3; got {p}")
    _check_split(n, t)


def _check_columns(n: int, p: Pass) -> None:
    """The fused column launch (:func:`column_plan`): pass A of an axis of
    M = R1 R2 points at stride K = N / M over columns of stride R2 K in
    place, its twiddle blind to the column, then pass B from columns of
    stride K to columns of stride R1 K."""
    t = p.then
    r1, r2 = p.radix, t.radix
    k = n // (r1 * r2)
    if (t.then or t.split or (r1, r2) not in COLUMN_PAIRS
            or n % (r1 * r2) or k < column_slab(r1, r2)
            or p != Pass(r1, ("col", r2 * k), ("col", r2 * k), r2 * k, True,
                         then=t, tw_lo=k)
            or t != Pass(r2, ("col", k), ("col", r1 * k), 0, False)):
        raise ValueError("the fused column launch is a column plan's two "
                         f"passes at radices {COLUMN_PAIRS}; got {p}")


def _check_fused(n: int, p: Pass) -> None:
    """A pass that carries the next: the fused tail or the fused column
    launch."""
    if p.then.split:
        _check_tail(n, p)
    else:
        _check_columns(n, p)


def _check_split(n: int, p: Pass) -> None:
    """The split is the epilogue of a plan's last pass: rows in, columns
    of stride N / R out, no twiddle (the kernel's to R = 256)."""
    if p.split not in (None, "pair"):
        raise ValueError(f"unknown split {p.split!r}")
    if p.split and (p.src[0] != "rows" or p.dst != ("col", n // p.radix)
                    or p.tw_s):
        raise ValueError("the pair split is the epilogue of a plan's last "
                         f"pass (rows in, columns of {n // p.radix} out, no "
                         f"twiddle); got {p}")


def factors_plan(n1: int, n2: int) -> tuple[Pass, ...]:
    """The JAX package's strided two-pass for N = n1 * n2 (B22, B23):
    pass 1 writes the twiddled Bmat rows (n2, n1)."""
    for r in (n1, n2):
        if not MIN_RADIX <= r <= MAX_RADIX or r & (r - 1):
            raise ValueError(f"factor {r} is not a power of two in "
                             f"[{MIN_RADIX}, {MAX_RADIX}]")
    return (Pass(n1, ("col", n2), ("rows", (n2,)), n2, True),
            Pass(n2, ("col", n1), ("col", n1), 0, False))


def default_passes(n: int) -> tuple[Pass, ...]:
    """The plan an N = 2^8..2^28 transform runs: rowfour's two factors
    for its sizes (ops/rowfour.FACTORS), hugefft's default plan above
    them, two even radices below."""
    from smfft_tpu_torch.ops import hugefft, rowfour
    if n in rowfour.FACTORS:
        return plan(rowfour.FACTORS[n])
    if n > 1 << 17:
        return hugefft.passes(n, None)
    return plan(radices(n, 2))


# ---------------------------------------------------------------------------
# Plain PyTorch version.
# ---------------------------------------------------------------------------


def _gather(x: torch.Tensor, r: int, m: tuple) -> torch.Tensor:
    """(B, N) -> (B, N/r, r): transform c's r points in order."""
    b, n = x.shape
    if m[0] == "col":
        s = m[1]
        return x.reshape(b, n // (r * s), r, s).transpose(2, 3).reshape(
            b, n // r, r)
    rad = m[1]
    q = len(rad)
    dims = (0,) + tuple(range(q, 0, -1)) + (q + 1,)
    return x.reshape((b,) + rad + (r,)).permute(dims).reshape(b, n // r, r)


def _scatter(y: torch.Tensor, r: int, m: tuple) -> torch.Tensor:
    """The inverse of :func:`_gather`: (B, N/r, r) -> (B, N)."""
    b, t, _ = y.shape
    n = t * r
    if m[0] == "col":
        s = m[1]
        return y.reshape(b, n // (r * s), s, r).transpose(2, 3).reshape(b, n)
    rad = m[1]
    q = len(rad)
    dims = (0,) + tuple(range(q, 0, -1)) + (q + 1,)
    return y.reshape((b,) + rad[::-1] + (r,)).permute(dims).reshape(b, n)


def _pass_twiddle(n: int, p: Pass, inverse: bool,
                  dtype: torch.dtype, device) -> torch.Tensor:
    """(N/R, R) twiddles of a pass: W_N^(s * k * N/(R tw_s)), s = c mod
    tw_s with its low log2 tw_lo bits cleared."""
    r = p.radix
    c = torch.arange(n // r, device=device)
    k = torch.arange(r, device=device)
    s = (c % p.tw_s) & ~(p.tw_lo - 1)
    m = (s * (n // (r * p.tw_s)))[:, None] * k[None, :]
    return FS.roots(m, n, inverse, dtype)


def pass_plain(x: torch.Tensor, n: int, p: Pass, inverse: bool = False,
               scale: float = 1.0):
    """One pass of :func:`launch_pass` in plain PyTorch: complex (B, N) ->
    complex (B, N), in x's precision; a ``split="pair"`` pass -> the
    packed planar half-spectra (2B, N/2) of its output; a pass with
    ``then`` is the two in turn."""
    if p.then:
        _check_fused(n, p)
        y = pass_plain(x, n, replace(p, then=None), inverse, scale)
        return pass_plain(y, n, p.then, inverse, scale)
    _check_split(n, p)
    b, r = x.shape[0], p.radix
    a = _gather(x, r, p.src)
    if p.scaled and scale != 1.0:
        a = a * scale
    yr, yi = C.c2c_plain(a.real.reshape(-1, r), a.imag.reshape(-1, r),
                         inverse=inverse)
    y = torch.complex(yr, yi).reshape(b, n // r, r)
    if p.tw_s:
        y = y * _pass_twiddle(n, p, inverse, y.dtype, y.device)
    y = _scatter(y, r, p.dst)
    if p.split:
        from smfft_tpu_torch.ops import real_fused as RF
        return RF.pair_split_plain(y, 2 * b)
    return y


def passes_plain(x: torch.Tensor, n: int, passes: tuple[Pass, ...],
                 inverse: bool = False, scale: float = 1.0):
    """Every pass of a plan in plain PyTorch (complex in, complex out; the
    planar spectra out of a plan whose last pass splits)."""
    for p in passes:
        x = pass_plain(x, n, p, inverse, scale)
    return x


def transform_plain(xr: torch.Tensor, xi: torch.Tensor, n: int,
                    passes: tuple[Pass, ...], inverse: bool = False,
                    scale: float = 1.0, exact: bool = False):
    """:func:`run_passes`'s function in plain PyTorch on any device:
    planar (B, N) in, planar out, at the tier's precision
    (``c2c.at_tier``: "exact" in float64, rounded once)."""
    def run(ar, ai):
        y = passes_plain(torch.complex(ar, ai), n, passes, inverse, scale)
        return y.real, y.imag
    return C.at_tier(run, exact, xr, xi)


# ---------------------------------------------------------------------------
# The kernel's wrapper.
# ---------------------------------------------------------------------------


def _operand(t, n: int, name: str):
    """(pointer a, pointer b, kind) of a CUDA operand: a complex64 (kind
    0) or complex128 (kind 2) (B, N) tensor, or a planar float32 pair
    (kind 1)."""
    planes = t if isinstance(t, tuple) else (t,)
    for u in planes:
        if u.device.type != "cuda":
            raise ValueError(f"{name} must be a CUDA tensor, got {u.device}")
        if u.dim() != 2 or u.shape[1] != n or not u.is_contiguous():
            raise ValueError(f"{name} must be contiguous (batch, {n}), got "
                             f"{tuple(u.shape)}")
    if isinstance(t, tuple):
        if t[0].shape != t[1].shape or any(u.dtype != torch.float32
                                           for u in t):
            raise ValueError(f"{name}: planar pair must be two float32 "
                             "tensors of one shape")
        return t[0].data_ptr(), t[1].data_ptr(), 1
    kinds = {torch.complex64: 0, torch.complex128: 2}
    if t.dtype not in kinds:
        raise TypeError(f"{name} must be complex64 or complex128, got "
                        f"{t.dtype}")
    if t.data_ptr() % t.element_size():
        raise ValueError(f"{name} must be aligned to its element size")
    return t.data_ptr(), None, kinds[t.dtype]


def _map_args(m: tuple):
    if m[0] == "col":
        return 0, m[1]
    return 1, 0


def launch_pass(src, dst, n: int, p: Pass, *, inverse: bool = False,
                scale: float = 1.0, exact: bool = False,
                at: tuple[int, int] | None = None, mid=None):
    """Launch ``fourstep_pass_kernel`` of ``csrc/fourstep.cu`` once on the
    current CUDA stream: pass ``p`` from ``src`` into ``dst`` (each a
    complex64 / complex128 (B, N) tensor or a planar float32 pair; they may
    be the same tensor for a column pass in place), and return ``dst``.
    A ``split="pair"`` pass writes the packed half-spectra instead: ``dst``
    is a spectrum of B..2B rows of N/2 bins as ``real_fused`` takes it (a
    planar pair, packed or numpy complex64), its q rows B after the p rows
    (a q row past its last is left out).  A fused tail (``p.then``, from
    :func:`tail_plan`) runs ``p`` in place on ``src``, a complex64
    intermediate, and its split pass into ``dst``.  A fused column launch
    (``p.then`` without a split, from :func:`column_plan`) runs pass A from
    ``src`` into ``mid`` (complex64; None: ``src`` itself, in place) and
    pass B from there into ``dst``, complex64 all.  ``dst`` and ``mid`` may
    be functions that make them, called here: the launch's ``alloc`` span.
    ``exact`` runs the fp64 instantiation.  ``at`` = (i, p): pass i of a
    plan of p, named in the span's variant; (i, p, axis): ``axis=<axis>``
    first there (the column route's ``col``).  Each launch that splits adds
    one to ``launch_pass.fused``, each fused tail one to
    ``launch_pass.tails``."""
    sp = _T.on and _T.now()
    a = t = c = rows = out = 0
    last = p.then or p
    cols = p.then is not None and not last.split
    try:
        if p.then:
            _check_fused(n, p)
        else:
            _check_split(n, p)
        ia, ib, ik = _operand(src, n, "src")
        if callable(dst):
            a = sp and _T.now()
            dst = out = dst()
        if cols and callable(mid):
            a = a or (sp and _T.now())
            mid = mid()
            out = mid if isinstance(out, int) else (out, mid)
        first = src[0] if isinstance(src, tuple) else src
        rows = first.shape[0]
        if last.split:
            from smfft_tpu_torch.ops import real_fused as RF
            oa, ob, layout, rows_out = RF._spec_args(dst, n // 2)
            ok = 0
            if not rows <= rows_out <= 2 * rows:
                raise ValueError(f"{rows_out} spectra do not match {rows} "
                                 "rows of the pair split's src")
        else:
            oa, ob, ok = _operand(dst, n, "dst")
            layout = -1
            rows_out = (dst[0] if isinstance(dst, tuple) else dst).shape[0]
            if rows_out != rows:
                raise ValueError(f"src has {rows} rows, dst {rows_out}")
        rad = next((m[1] for m in (p.src, p.dst) if m[0] == "rows"), ())
        if len(rad) > 4:
            raise ValueError("a row map takes at most 4 radices")
        rad = tuple(rad) + (0,) * (4 - len(rad))
        nr = sum(1 for v in rad if v)
        dev = first.device
        t = sp and _T.now()
        tw = C.device_twiddles(p.radix, bool(inverse), bool(exact), dev)
        lo, hi = FS.device_roots(n, bool(inverse), bool(exact), dev)
        tail, ma = (0, None, None), None
        if cols:
            mid = first if mid is None else mid
            if ik != 0 or ok != 0 or exact:
                raise ValueError("the fused column launch runs complex64 in "
                                 "and out")
            ma = _operand(mid, n, "mid")[0]
            if mid.dtype != torch.complex64 or mid.shape[0] != rows:
                raise ValueError(f"mid must be complex64 ({rows}, {n})")
            r1, r2 = p.radix, last.radix
            words = _words(_column_sync, first,
                           rows * (n // (r1 * r2)) // column_slab(r1, r2))
        elif p.then:
            if ik != 0 or exact or (p.radix, last.radix) != (TAIL_RADIX,) * 2:
                raise ValueError("the fused tail runs radix 128 twice in "
                                 "place on a complex64 intermediate")
            words = _words(_tail_sync, first,
                           rows * n // p.radix // last.radix)
        if p.then:
            tail = (last.radix, C.device_twiddles(
                last.radix, bool(inverse), False, dev).data_ptr(),
                words.data_ptr())
        c = sp and _T.now()
        _cuda.launch(
            _cuda.FOURSTEP_PASS, first.get_device(),
            ("fourstep pass launch (n={}, radix={}, batch={})", n, p.radix,
             rows),
            ia, ib, ik, *_map_args(p.src), oa, ob, ok, *_map_args(p.dst), nr,
            *rad, rows, n, p.radix, p.tw_s, p.tw_lo,
            float(scale) if p.scaled else 1.0, tw.data_ptr(), lo.data_ptr(),
            hi.data_ptr(), FS.lo_bits(n), int(inverse), int(exact), layout,
            rows_out, *tail, ma)
        launch_pass.fused += bool(last.split)
        launch_pass.tails += bool(p.then and last.split)
    finally:
        if sp:
            variant = ((f"axis={at[2]} " if at and len(at) > 2 else "")
                       + f"radix={p.radix}"
                       + (f"+{last.radix}" if p.then else "")
                       + (f" pass={at[0]}" + (f"-{at[0] + 1}" if p.then
                                                else "") + f"/{at[1]}"
                          if at else "")
                       + (f" split={last.split}" if last.split else "")
                       + (" tail=l2" if p.then else ""))
            _T.launched(sp, a, t, c, out, "launch:fourstep_pass", variant,
                        exact, rows, n)
    return dst


launch_pass.fused = 0
launch_pass.tails = 0

#: The fused tail's device words by (device, raw stream): the ticket, the
#: count of split items that found a block not yet written, the epoch of
#: the last launch, the blocks of a launch that have left, then one
#: counter a block (Z row, pass-1 digit).  The kernel keeps them: a launch
#: takes the next epoch, so a counter of an older launch reads as unset,
#: and its last block sets the ticket back.  A launch needs nothing from
#: the host, so a CUDA graph replays it, and no launch clears the words.
_tail_sync: dict = {}

#: The fused column launch's device words, as the tail's, with one counter
#: a slab (W columns of a row) of pass-A items done.
_column_sync: dict = {}

#: Words outgrown by a larger batch, kept because a captured CUDA graph
#: may still launch on them.
_retired: list = []


def _words(table: dict, like: torch.Tensor, counters: int) -> torch.Tensor:
    """The words of ``table`` for a launch with ``counters`` counters on
    ``like``'s device and current stream."""
    dev = like.get_device()
    key = (dev, _cuda._raw_stream(dev))
    words = table.get(key)
    if words is None or words.numel() < 4 + counters:
        grown = torch.zeros(4 + counters, dtype=torch.int64,
                            device=like.device)
        if words is not None:
            grown[1] = words[1]
            _retired.append(words)
        words = table[key] = grown
    return words


def _waits(table: dict) -> int:
    for words in table.values():
        if words.is_cuda:
            torch.cuda.synchronize(words.device)
    return sum(int(words[1]) for words in table.values())


def tail_waits() -> int:
    """The fused tail's split items, over every launch in this process,
    whose blocks were not all written when the item was handed out (it
    then waited for them): read after a synchronize."""
    return _waits(_tail_sync)


def column_waits() -> int:
    """The fused column launch's pass-B items, over every launch in this
    process, whose slab's pass-A items were not all done when the item was
    handed out (it then waited for them): read after a synchronize."""
    return _waits(_column_sync)


def _alloc(like: torch.Tensor, rows: int, n: int, planar: bool):
    if planar:
        return tuple(torch.empty((rows, n), device=like.device)
                     for _ in range(2))
    return torch.empty((rows, n), dtype=torch.complex64, device=like.device)


def run_passes(src, n: int, passes: tuple[Pass, ...], *,
               inverse: bool = False, scale: float = 1.0,
               exact: bool = False, dst=None, planar_out: bool | None = None,
               tmp=None, axis: str | None = None):
    """The transform of a plan: ``src`` a complex (B, N) tensor or a
    planar pair.  Writes into ``dst`` when given (a complex64 /
    complex128 tensor or a planar pair), else returns a new result in
    src's form (complex64, or planar float32 when ``planar_out``).

    CUDA: one launch a pass, the middle passes in place on one
    intermediate (complex64, complex128 for ``exact``), made by the first
    pass; ``dst`` may be a function that makes it, called by the last
    pass, which makes the new result too (each launch's ``alloc`` span).
    ``tmp`` may be that intermediate, given (``src`` itself: the first
    pass then runs in place); a fused column launch writes its
    intermediate there.  A plan whose last pass splits
    (:func:`pair_split_plan`) writes its spectra into ``dst``
    (:func:`launch_pass`), its last two passes one launch where
    :func:`tail_plan` fuses them; its plain version is
    ``real_fused.rfft_large_plain``.  ``axis`` names the launches' spans'
    axis (:func:`launch_pass`).
    CPU: the plain version at the tier's precision (``c2c.at_tier``)."""
    planar_in = isinstance(src, tuple)
    planar_out = planar_in if planar_out is None else planar_out
    first = src[0] if planar_in else src
    if C.is_cpu(first):
        planes = src if planar_in else (src.real, src.imag)
        yr, yi = transform_plain(*planes, n, passes, inverse, scale, exact)
        if dst is None:
            return (yr, yi) if planar_out else torch.complex(yr, yi)
        if callable(dst):
            dst = dst()
        if isinstance(dst, tuple):
            dst[0].copy_(yr)
            dst[1].copy_(yi)
        else:
            dst.copy_(torch.complex(yr, yi))
        return dst
    rows = first.shape[0]
    if dst is None:
        dst = partial(_alloc, first, rows, n, planar_out)
    if tmp is None:
        tmp = partial(torch.empty, (rows, n), device=first.device,
                      dtype=torch.complex128 if exact else torch.complex64)
    # the first pass makes tmp, the middle ones run in place on it, the
    # last writes dst
    cur, k, i = src, sum(2 if p.then else 1 for p in passes), 1
    passes = tail_plan(n, passes, exact)
    for p in passes:
        # a fused column launch's intermediate
        mid = {"mid": tmp} if p.then and not p.then.split else {}
        cur = tmp = launch_pass(cur, dst if p is passes[-1] else tmp, n, p,
                                inverse=inverse, scale=scale, exact=exact,
                                at=(i, k) if axis is None else (i, k, axis),
                                **mid)
        i += 2 if p.then else 1
    return cur


def column_plan(m: int, k: int, exact: bool = False) -> tuple[Pass, ...]:
    """The launches of a C2C over an axis of m points at stride k (both
    powers of two, m <= 16384) of (B, m k) rows, natural order out: one
    column pass of stride k to m = 2048; above, m = R1 R2
    (:func:`radices`), a pass of radix R1 in place over columns of stride
    R2 k, twiddled by W_m^(b k_a) for transform s = b k + column, then one
    of radix R2 from columns of stride k to columns of stride R1 k, which
    lands X[k_a + R1 k_b] of column c at (k_a + R1 k_b) k + c.  The scale
    is the first pass's.  The two passes are one launch, the first
    carrying the second (``then``: the fused column launch, which hands
    each slab of W = :func:`column_slab` columns from the one to the other
    through L2), where the shape allows: fp32, (R1, R2) in
    :data:`COLUMN_PAIRS` and k >= W; else two launches."""
    if m <= MAX_RADIX:
        return (Pass(m, ("col", k), ("col", k), 0, True),)
    r1, r2 = radices(m, 2)
    a = Pass(r1, ("col", r2 * k), ("col", r2 * k), r2 * k, True, tw_lo=k)
    b = Pass(r2, ("col", k), ("col", r1 * k), 0, False)
    if exact or (r1, r2) not in COLUMN_PAIRS or k < column_slab(r1, r2):
        return (a, b)
    return (replace(a, then=b),)


def run_columns(x: torch.Tensor, m: int, k: int, *, inverse: bool = False,
                scale: float = 1.0, exact: bool = False,
                own: bool = False) -> torch.Tensor:
    """The C2C over an axis of m points at stride k of a contiguous
    complex tensor ``x`` viewed (B, m k): :func:`column_plan`'s launches,
    natural order, ``scale`` on the input; a new (B, m k) tensor, or ``x``
    itself.  On a card, ``own`` says that nothing else holds ``x``: the
    first pass then runs in place on it (the one pass of m <= 2048 returns
    ``x``; complex64 alone, the "exact" tier's intermediate is
    complex128).  Each call adds one to ``run_columns.calls``, each that
    takes the fused column launch on a card one to ``run_columns.fused``
    (an ``x`` that is not 16-byte aligned takes the two launches; one not
    128-byte aligned is not the fused launch's intermediate)."""
    n = m * k
    passes = column_plan(m, k, exact)
    run_columns.calls += 1
    if C.is_cpu(x):
        return run_passes(x, n, passes, inverse=inverse, scale=scale,
                          exact=exact, axis="col")
    if passes[0].then:
        # the fused launch reads x 16 bytes at a time, and drops whole
        # 128-byte lines of its intermediate
        if x.data_ptr() % 16:
            passes = (replace(passes[0], then=None), passes[0].then)
        own = own and not x.data_ptr() % 128
    run_columns.fused += passes[0].then is not None
    if not own or exact and len(passes) > 1:
        return run_passes(x, n, passes, inverse=inverse, scale=scale,
                          exact=exact, axis="col")
    if len(passes) == 1 and not passes[0].then:
        return run_passes(x, n, passes, inverse=inverse, scale=scale,
                          exact=exact, dst=x, axis="col")
    return run_passes(x, n, passes, inverse=inverse, scale=scale, tmp=x,
                      axis="col")


run_columns.calls = 0
run_columns.fused = 0


# ---------------------------------------------------------------------------
# The JAX package's planar entry points.
# ---------------------------------------------------------------------------


def _pair(vr: torch.Tensor, vi: torch.Tensor):
    if vr.shape != vi.shape:
        raise ValueError(f"planar pair shapes differ: {tuple(vr.shape)} vs "
                         f"{tuple(vi.shape)}")
    n = vr.shape[-1]
    return (_cuda.contiguous(vr.to(torch.float32)).reshape(-1, n),
            _cuda.contiguous(vi.to(torch.float32)).reshape(-1, n))


def dispatch_planar(vr: torch.Tensor, vi: torch.Tensor, *,
                    inverse: bool = False, precision: str | None = None,
                    scale: float = 1.0):
    """Planar huge-N C2C dispatch behind planar.fft_large: row sizes (N <=
    16384) go to the row kernel (``csrc/c2c.cu``), N = 2**15..2**17 to
    rowfour's two passes, N = 2**18..2**28 to hugefft's plan."""
    from smfft_tpu_torch import planar
    from smfft_tpu_torch.ops import hugefft, rowfour
    n = vr.shape[-1]
    if n in P.SUPPORTED_C2C_SIZES:
        return planar._run(vr, vi, precision, inverse=inverse, ordered=True,
                           scale=scale if scale != 1.0 else None)
    if n in rowfour.FACTORS:
        return rowfour.fft_rowfour_planar(vr, vi, inverse=inverse,
                                          precision=precision, scale=scale)
    return hugefft.fft_huge_planar(vr, vi, inverse=inverse,
                                   precision=precision, scale=scale)


def fft_large_planar(vr: torch.Tensor, vi: torch.Tensor, *,
                     inverse: bool = False, precision: str = "highest",
                     scale: float = 1.0,
                     factors: tuple[int, int] | None = None):
    """Huge-N C2C over the last axis, planar fp32 in and out, natural
    order, unnormalized unless ``scale``.  With ``factors`` = (n1, n2) the
    JAX package's strided two-pass (B22, B23: the factors must lie in
    [16, 2048]); without, the default plan (:func:`default_passes`)."""
    from smfft_tpu_torch import api
    n = vr.shape[-1]
    if factors is not None:
        n1, n2 = factors
        if n1 * n2 != n:
            raise ValueError(f"factors {n1}*{n2} != N={n}")
        passes = factors_plan(n1, n2)
    else:
        FS.split_factors(n, 128)
        passes = default_passes(n)
    o_r, o_i = run_passes(_pair(vr, vi), n, passes, inverse=inverse,
                          scale=scale, exact=api._exact(precision))
    return o_r.reshape(vr.shape), o_i.reshape(vi.shape)


def large_pass1_planar(vr: torch.Tensor, vi: torch.Tensor, n1: int, n2: int,
                       *, inverse: bool = False, precision: str = "highest",
                       scale: float = 1.0):
    """Pass 1 of the strided two-pass alone (B22's function): (..., N)
    planar -> the twiddled Bmat as planar (b * n2, n1), Bmat[b, t2, k1] =
    scale * W_N^(t2 k1) * sum_t1 x[b, t1 n2 + t2] W_n1^(t1 k1)."""
    from smfft_tpu_torch import api
    n = n1 * n2
    src = _pair(vr, vi)
    o_r, o_i = run_passes(src, n, factors_plan(n1, n2)[:1], inverse=inverse,
                          scale=scale, exact=api._exact(precision))
    return o_r.reshape(-1, n1), o_i.reshape(-1, n1)
