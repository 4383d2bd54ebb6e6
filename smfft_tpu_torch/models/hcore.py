"""The Hopper core of ``csrc/hcore.cuh`` and the tile schedule of
``csrc/fourstep.cu``, modelled on the CPU.

What a CPU can check of the two kernels built on that core
(``bluestein_kernel``, ``fourstep_pass_kernel``), with the kernels' own
index arithmetic written out in numpy:

  * the stage ladder (radix-16 stages and one last radix of 2, 4, 8 or 16)
    and its index maps, thread by thread, give the DFT
    (:func:`core`), with the first stage's zero half skipped and the last
    stage's upper half left out where the kernel does that;
  * the shared-memory addresses of every stage, under each kernel's
    thread-to-transform map and padding, and the wavefronts a warp needs
    for them (:func:`wavefronts`, :func:`bluestein_patterns`,
    :func:`pass_patterns`);
  * the persistent tile schedule of the pass kernel
    (:func:`tile_schedule`).

Conventions follow the kernel: M points a transform, TPF threads a
transform, E = M / TPF points a thread; thread t holds the points t + s*TPF
(s < E) in its array u[s] before the first stage and after the last.
"""

from __future__ import annotations

import numpy as np

BANKS = 32


def radices(m: int) -> list[int]:
    """The stage ladder of an m-point transform: radix-16 stages, the last
    one of radix 2, 4, 8 or 16 (m = 16 ... 16384)."""
    k = m.bit_length() - 1
    if m != 1 << k or not 4 <= k <= 14:
        raise ValueError(f"m={m} is not a power of two in 16..16384")
    rs = [16] * (k // 4)
    if k % 4:
        rs.append(1 << (k % 4))
    return rs


def points_per_thread(m: int) -> int:
    """E of the Bluestein core: 16 points a thread, 32 at m >= 8192."""
    return 32 if m >= 8192 else 16


def stage_p(m: int) -> list[int]:
    """Sub-length p of each stage: 1, 16, 256, ..."""
    out, p = [], 1
    for r in radices(m):
        out.append(p)
        p *= r
    return out


def stockham_dst(i, p: int, r_s: int, r: int):
    """Where butterfly i of a stage (sub-length p, radix r_s) writes its
    output r."""
    k = i % p
    return (i - k) * r_s + k + r * p


def _dft(v: np.ndarray, sign: float) -> np.ndarray:
    """DFT over the last axis of v (..., R)."""
    r = v.shape[-1]
    w = np.exp(sign * 2j * np.pi * np.outer(np.arange(r), np.arange(r)) / r)
    return v @ w


def core(x: np.ndarray, tpf: int, inverse: bool = False,
         zero_half: bool = False, lower_half: bool = False) -> np.ndarray:
    """The core on rows x (B, M), thread by thread: returns X (B, M), natural
    order.  ``zero_half``: the first stage reads only its operands r < 8
    (the inputs j >= M/2, which must be zero, are never loaded);
    ``lower_half``: the last stage computes only its outputs r < RL/2 (the
    points k < M/2), the rest of X is left 0."""
    b, m = x.shape
    e = m // tpf
    sign = 1.0 if inverse else -1.0
    rs, ps = radices(m), stage_p(m)
    t = np.arange(tpf)
    # u[:, t, s] = x[t + s*TPF]
    u = x[:, t[:, None] + np.arange(e)[None, :] * tpf]
    buf = np.zeros((b, m), complex)
    out = np.zeros((b, m), complex)
    for st, (r_s, p) in enumerate(zip(rs, ps)):
        q_n = e // r_s
        step = m // r_s
        for q in range(q_n):
            i = t + q * tpf                             # butterflies (TPF,)
            r = np.arange(r_s)
            if st == 0:
                # operand r of butterfly i is point i + r*M/16 = u[q + r*step/TPF]
                v = u[:, :, q + r * (step // tpf)]
                if zero_half:
                    v = v.copy()
                    v[:, :, r_s // 2:] = 0
            else:
                v = buf_in[:, i[:, None] + r[None, :] * step]
            k = i % p
            tw = np.exp(sign * 2j * np.pi * np.outer(k, r) / (p * r_s))
            y = _dft(v * tw, sign)
            if st == len(rs) - 1:
                # last stage: output r of butterfly i is point i + r*p
                keep = r_s // 2 if lower_half else r_s
                for rr in range(keep):
                    out[:, i + rr * p] = y[:, :, rr]
            else:
                dst = stockham_dst(i[:, None], p, r_s, r[None, :])
                buf[:, dst] = y
        buf_in = buf.copy()
    return out


def bluestein(x: np.ndarray, n: int, m: int, inverse: bool = False,
              h_order: np.ndarray | None = None) -> np.ndarray:
    """The n-point DFT of rows x (B, n) as the kernel computes it: the
    pre-chirp, the forward core with its zero half skipped, the product with
    H in the order the forward core leaves the spectrum in the threads'
    registers (natural: thread t holds points t + s*TPF before and after),
    the inverse core with only its lower half of outputs, the post-chirp.
    ``h_order``: H as stored, indexed by the point the register holds."""
    tpf = m // points_per_thread(m)
    j = np.arange(n)
    w = np.exp(-1j * np.pi * ((j * j) % (2 * n)) / n)
    bb = np.zeros(m, complex)
    bb[:n] = np.conj(w)
    bb[m - n + 1:] = np.conj(w[1:][::-1])
    h = np.fft.fft(bb) / m
    if inverse:
        w, h = np.conj(w), np.conj(h)
    a = np.zeros((x.shape[0], m), complex)
    a[:, :n] = x * w
    f = core(a, tpf, False, zero_half=True)
    g = f * (h if h_order is None else h_order)
    c = core(g, tpf, True, lower_half=True)
    return c[:, :n] * w


# ---------------------------------------------------------------------------
# Shared-memory banks.
# ---------------------------------------------------------------------------


def wavefronts(byte_addrs, width: int) -> int:
    """Wavefronts one warp instruction needs: each lane reads or writes
    ``width`` bytes at its address; a bank serves one distinct 4-byte word
    a wavefront (lanes on one word share it).  The minimum is width / 4
    for 32 lanes (2 for 8-byte, 4 for 16-byte elements)."""
    words = set()
    for a in byte_addrs:
        for w in range(a // 4, (a + width) // 4):
            words.add(w)
    per_bank = np.bincount([w % BANKS for w in words], minlength=BANKS)
    return int(per_bank.max())


def pad16(idx):
    """The Bluestein core's padding: one element after every 16."""
    return idx + (idx >> 4)


def slot_elems(m: int) -> int:
    """Elements of one padded Bluestein slot (a transform's buffer)."""
    return pad16(m)


def _stage_indices(m: int, tpf: int, from_smem_first: bool):
    """Every stage access of thread t as functions of t: a list of (kind,
    fn(t) -> element index), one per warp instruction; kind 'r' / 'w'."""
    e = m // tpf
    acc = []
    rs, ps = radices(m), stage_p(m)
    for st, (r_s, p) in enumerate(zip(rs, ps)):
        step = m // r_s
        for q in range(e // r_s):
            for r in range(r_s):
                if st > 0 or from_smem_first:
                    acc.append(("r", lambda t, q=q, r=r, step=step:
                                t + q * tpf + r * step))
                if st < len(rs) - 1:
                    acc.append(("w", lambda t, q=q, r=r, p=p, r_s=r_s:
                                stockham_dst(t + q * tpf, p, r_s, r)))
    return acc


def bluestein_patterns(m: int, elem: int):
    """(what, wavefronts) for every shared-memory access of one Bluestein
    block: rows t-fastest (lane = row * TPF + t), slots of
    :func:`slot_elems` elements, :func:`pad16` inside a slot, ``elem``
    bytes an element; and the stage twiddle table reads (tab[k], k = i mod
    p, contiguous per stage)."""
    tpf = m // points_per_thread(m)
    rows = max(1, 128 // tpf)
    threads = rows * tpf
    out = []
    for kind, fn in _stage_indices(m, tpf, False):
        for w0 in range(0, threads, 32):
            lanes = [w0 + l for l in range(min(32, threads))]
            addrs = [((ln // tpf) * slot_elems(m) + pad16(fn(ln % tpf)))
                     * elem for ln in lanes]
            out.append((kind, wavefronts(addrs, elem)))
    e = m // tpf
    for r_s, p in zip(radices(m)[1:], stage_p(m)[1:]):
        for q in range(e // r_s):
            for w0 in range(0, threads, 32):
                lanes = [w0 + l for l in range(min(32, threads))]
                addrs = [((ln % tpf + q * tpf) % p) * elem for ln in lanes]
                out.append(("tw", wavefronts(addrs, elem)))
    return out


# ---------------------------------------------------------------------------
# The pass kernel: tiles of T transforms, lanes transform-fastest.
# ---------------------------------------------------------------------------


def pass_geometry(r: int, exact: bool) -> dict:
    """The pass kernel's layout at radix R (``csrc/fourstep.cu``
    PassTile): T transforms a tile, E points a thread, TPF threads a
    transform, FW transforms across a warp's lanes, NB tile buffers, LD the
    slot stride in elements, whether points are :func:`pad16`-ed inside a
    slot (R >= 1024, whose tiles hold fewer transforms than a 128-byte
    segment), the element size."""
    elem = 16 if exact else 8
    seg = 128 // elem                  # transforms in one 128-byte segment
    budget = 140 * 1024                # bytes of tiles a block may hold
    t = max(seg, (2048 if exact else 4096) // r)
    while t > 1 and t * (r + 1) * elem > budget:
        t //= 2
    nb = 2 if 2 * t * (r + 1) * elem <= budget else 1
    if nb == 1 and t // 2 >= seg // 2:
        # two tiles of half a segment rather than one of a segment
        t, nb = t // 2, 2
    pad = t < seg
    ld = pad16(r) + (0 if exact else 2) if pad else r + 1
    e = 16 if t * r // 16 <= (256 if exact else 512) else 32
    tpf = r // e
    return {"T": t, "E": e, "TPF": tpf, "FW": min(t, seg), "NB": nb,
            "LD": ld, "pad": pad, "elem": elem, "threads": t * tpf}


def pass_lane(tid: int, g: dict) -> tuple[int, int]:
    """(f, t) of thread tid: FW transforms across the lanes, then t."""
    fw, tpf = g["FW"], g["TPF"]
    return tid % fw + fw * (tid // (fw * tpf)), (tid // fw) % tpf


def pass_patterns(r: int, exact: bool):
    """(what, wavefronts) for every shared-memory access of one pass
    tile: the copy of a column tile (element e -> transform e mod T, point
    e / T) and of a row tile (transform e / R, point e mod R), the stages
    from the staged tile under :func:`pass_lane`, the row-out staging."""
    g = pass_geometry(r, exact)
    elem, ld, th = g["elem"], g["LD"], g["threads"]
    t_n = g["T"]
    pad = pad16 if g["pad"] else (lambda i: i)
    out = []
    for w0 in range(0, th, 32):
        for k in range(t_n * r // th):
            es = [w0 + l + k * th for l in range(32)]
            out.append(("copy col", wavefronts(
                [((e % t_n) * ld + pad(e // t_n)) * elem for e in es], elem)))
            out.append(("copy row", wavefronts(
                [((e // r) * ld + pad(e % r)) * elem for e in es], elem)))
    lanes = [pass_lane(tid, g) for tid in range(th)]
    stages = _stage_indices(r, g["TPF"], True)
    # the last stage's outputs, natural index t + s*TPF, for a row store
    stages += [("w", lambda t, s=s: t + s * g["TPF"]) for s in range(g["E"])]
    for kind, fn in stages:
        for w0 in range(0, th, 32):
            addrs = [(f * ld + pad(fn(t))) * elem
                     for f, t in lanes[w0:w0 + 32]]
            out.append((kind, wavefronts(addrs, elem)))
    e = g["E"]
    for r_s, p in zip(radices(r)[1:], stage_p(r)[1:]):
        for q in range(e // r_s):
            for w0 in range(0, th, 32):
                addrs = [((t + q * g["TPF"]) % p) * elem
                         for _, t in lanes[w0:w0 + 32]]
                out.append(("tw", wavefronts(addrs, elem)))
    return out


def tile_schedule(n_tiles: int, grid: int) -> list[list[int]]:
    """The persistent grid's tiles, block by block: block b takes tiles b,
    b + grid, b + 2 grid, ... (the kernel's loop)."""
    return [list(range(b, n_tiles, grid)) for b in range(grid)]


def grid_size(n_tiles: int, sms: int, per_sm: int) -> int:
    """Blocks the launcher starts: one for every resident slot on the card,
    at most one a tile."""
    return max(1, min(n_tiles, sms * per_sm))
