"""The Hopper core of ``csrc/hcore.cuh``, the tile schedule of
``csrc/fourstep.cu``, the row layout of ``csrc/c2c.cu``, the R2C kernel
of ``csrc/real.cu`` and the C2R kernel of ``csrc/c2r.cu``, the reuse
loops of ``csrc/multiple.cu`` and the fused convolutions of
``csrc/conv.cu``, modelled on the CPU.

What a CPU can check of the nine kernels built on that core
(``bluestein_kernel``, ``fourstep_pass_kernel``, ``c2c_kernel``,
``r2c_kernel``, ``c2r_kernel``, ``c2c_multiple_kernel``,
``real_multiple_kernel``, ``conv_kernel``, ``conv_real_kernel``), with the
kernels' own index arithmetic written out in numpy:

  * the stage ladder (radix-16 stages and one last radix of 2, 4, 8 or 16)
    and its index maps, thread by thread, give the DFT
    (:func:`core`), with the first stage's zero half skipped and the last
    stage's upper half left out where the kernel does that;
  * the shared-memory addresses of every stage, under each kernel's
    thread-to-transform map and padding, and the wavefronts a warp needs
    for them (:func:`wavefronts`, :func:`bluestein_patterns`,
    :func:`pass_patterns`);
  * the persistent tile schedule of the pass kernel
    (:func:`tile_schedule`), and its pair-split epilogue: the split
    pass's tile (:func:`split_geometry`), the pairs of transforms its
    slots hold (:func:`pass_split_slot`), the mirror
    points read through the slots and the bins stored
    (:func:`pass_split`), and the wavefronts of what it adds
    (:func:`pass_split_patterns`); the fused tail's work order
    (:func:`tail_items`), the blocks each split item waits for
    (:func:`tail_reads`), the rows its slots read (:func:`tail_slot_row`)
    and a group pair's bytes (:func:`tail_group_bytes`); the fused column
    launch's work order (:func:`column_items`), the points each item reads
    and writes (:func:`column_points`) and the slabs open at once
    (:func:`column_in_flight`);
  * the row kernels' block layout (:func:`row_geometry`), their revblock
    staging (:func:`stage_pos`), the C2C kernel's layouts
    (:func:`c2c_rows`), the R2C kernel's pair split and its stores in
    each layout (:func:`r2c_rows`), the C2R kernel's loads of each point
    and its mirror and their merge in the registers (:func:`c2r_rows`),
    and the wavefronts of every access (:func:`row_patterns`);
  * the reuse loops of ``csrc/multiple.cu`` on those blocks: the natural
    hand-off in the registers (:func:`last_stage_points`), the revblock
    hand-off through the staging (:func:`multiple_rows`), the real round
    trip's in-place pair split and merge (:func:`real_multiple_rows`), and
    the wavefronts of what they add (:func:`multiple_patterns`);
  * the fused convolutions of ``csrc/conv.cu`` on the same blocks
    (:func:`conv_geometry`): the product with H at the points the forward
    core's last stage leaves in the registers and the inverse core from
    them, the bank's m inverses (:func:`conv_rows`); the real kernel's
    split, product and merge of each pair in place, slot 0 and the
    self-pair (:func:`conv_real_rows`); the wavefronts of the pair step
    and the W_n^k table (:func:`conv_patterns`).

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


def pass_patterns(r: int, exact: bool, g: dict | None = None):
    """(what, wavefronts) for every shared-memory access of one pass
    tile: the copy of a column tile (element e -> transform e mod T, point
    e / T) and of a row tile (transform e / R, point e mod R), the stages
    from the staged tile under :func:`pass_lane`, the row-out staging;
    under geometry ``g`` (default :func:`pass_geometry`)."""
    g = g or pass_geometry(r, exact)
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


def split_geometry(r: int, exact: bool) -> dict:
    """The split pass's tile (``csrc/fourstep.cu`` SplitTile, R = 16..256):
    two buffers of twice the plain pass's transforms, so that a side's T/2
    adjacent transforms store runs of T/2 bins; E = 16 points a thread up
    to 512 threads (256 for "exact"), else 32; the lanes of a warp across
    32 transforms of a side where a side has 32, else the plain pass's
    FW."""
    g = pass_geometry(r, exact)
    t = 2 * g["T"]
    e = 16 if t * r // 16 <= (256 if exact else 512) else 32
    fw = 32 if t // 2 >= 32 else g["FW"]
    return {**g, "T": t, "NB": 2, "E": e, "TPF": r // e, "FW": fw,
            "threads": t * (r // e)}


def pass_split_slot(g: dict, tile: int, f: int, s: int, total: int) -> int:
    """The transform in slot f of tile ``tile`` of a split pass (S = N/R
    transforms a row, ``total`` in all), or -1 past the last pair
    (``csrc/fourstep.cu`` split_transform): pair P = tile * T/2 + f mod
    T/2 over every row, S/2 a row; slot f < T/2 transform P of its row,
    slot f + T/2 its mirror S - P, or S/2 for P = 0."""
    h = g["T"] // 2
    pg = tile * h + f % h
    if pg >= total // 2:
        return -1
    half = s // 2
    p = pg % half
    c = p if f < h else (s - p if p else half)
    return (pg // half) * s + c


def pass_split(z: np.ndarray, r: int, exact: bool, rows: int):
    """The pair split as the last pass's epilogue forms it, from the pass's
    output Z (B, N) in natural order (transform c's point k is Z[c + k S]):
    each tile's slots hold its transforms' points k >= R/2, each thread
    reads the mirrors of its points k < R/2 from the other slot of its
    pair (its own slot for transforms 0 and S/2), and stores bins c + k S
    of spectrum rows r (X_p) and r + B (X_q, if < ``rows``).  Returns the
    packed spectra (rows, N/2) and how many times each bin was stored."""
    b, n = z.shape
    s = n // r
    g = split_geometry(r, exact)
    t_n, e, tpf, ld = g["T"], g["E"], g["TPF"], g["LD"]
    h = t_n // 2
    pad = pad16 if g["pad"] else (lambda i: i)
    total = b * s
    spec = np.zeros((rows, n // 2), complex)
    stores = np.zeros((rows, n // 2), int)
    lanes = [pass_lane(tid, g) for tid in range(g["threads"])]
    upper = np.arange(r // 2, r)
    for tile in range(-(-total // t_n)):
        slots = np.full(t_n * ld, np.nan, complex)
        gs = [pass_split_slot(g, tile, f, s, total) for f in range(t_n)]
        for f, gf in enumerate(gs):
            if gf >= 0:
                row, c = divmod(gf, s)
                slots[f * ld + pad(upper)] = z[row, c + upper * s]
        for f, t in lanes:
            if gs[f] < 0:
                continue
            row, c = divmod(gs[f], s)
            mate = f if c in (0, s // 2) else f ^ h
            k = t + np.arange(e // 2) * tpf
            a = z[row, c + k * s]
            if c == 0:
                m = slots[f * ld + pad(np.where(k > 0, r - k, r // 2))]
            else:
                m = slots[mate * ld + pad(r - 1 - k)]
            p = 0.5 * (a + m.conj())
            q = -0.5j * (a - m.conj())
            if c == 0 and t == 0:   # k = 0: (DC, Nyquist) of each row
                p[0] = complex(a[0].real, m[0].real)
                q[0] = complex(a[0].imag, m[0].imag)
            bins = c + k * s
            spec[row, bins] = p
            stores[row, bins] += 1
            if row + b < rows:
                spec[row + b, bins] = q
                stores[row + b, bins] += 1
    return spec, stores


def pass_split_patterns(r: int, exact: bool):
    """(what, wavefronts) for the shared-memory accesses of one split
    tile: the row copy and the core's stages under its geometry
    (:func:`pass_patterns`), each thread's outputs k >= R/2 into its slot,
    and the mirrors R-1-k of its points k < R/2 from the other slot of its
    pair."""
    g = split_geometry(r, exact)
    elem, ld, th, e, tpf = g["elem"], g["LD"], g["threads"], g["E"], g["TPF"]
    h = g["T"] // 2
    pad = pad16 if g["pad"] else (lambda i: i)
    lanes = [pass_lane(tid, g) for tid in range(th)]
    out = [w for w in pass_patterns(r, exact, g) if w[0] != "copy col"]
    for w0 in range(0, th, 32):
        warp = lanes[w0:w0 + 32]
        for j in range(e // 2):
            out.append(("split w", wavefronts(
                [(f * ld + pad(t + (e // 2 + j) * tpf)) * elem
                 for f, t in warp], elem)))
            out.append(("split mirror", wavefronts(
                [((f ^ h) * ld + pad(r - 1 - t - j * tpf)) * elem
                 for f, t in warp], elem)))
    return out


# ---------------------------------------------------------------------------
# The fused tail (``csrc/fourstep.cu`` fourstep_pass_kernel<R2, R3, false,
# true, true>): pass 2 and the split pass of a three-pass pair-mode plan
# (R1, R2, R3) in one persistent launch.  Pass 1's output digit d1 cuts
# each Z row into R1 blocks of N/R1 points; pass 2 stays inside a block;
# split tile (d2, g) reads row d2 of the H blocks g*H .. g*H + H - 1 and
# row R2-1-d2 of their mirrors (R1 - d1) mod R1.  Group pair j of a row
# holds groups j and G-1-j (G = R1/H): its producers write its 2H blocks,
# its split tiles read them (and one block of each neighbouring pair).
# Tickets run the producers of pair 0, then for each pair q the producers
# of q + 1 and the split tiles of q.
# ---------------------------------------------------------------------------


def tail_geometry(r2: int, r3: int) -> dict:
    """The fused tail's items at radices (R2, R3) (TailTile): the split
    pass's tile and threads (:func:`split_geometry`) for a split item, H
    pairs; a pass-2 item of T2 = threads * E / R2 adjacent transforms, E
    points a thread, per_block of them a block of R3 transforms; NP pass-2
    items and NC split items a group pair."""
    s = split_geometry(r3, False)
    t2 = s["threads"] * s["E"] // r2
    h = s["T"] // 2
    per_block = r3 // t2
    return {"threads": s["threads"], "E": s["E"], "T2": t2,
            "TPF2": r2 // s["E"], "H": h, "per_block": per_block,
            "NP": 2 * h * per_block, "NC": r2}


#: group pairs between a pair's pass-2 items and its split items
#: (``csrc/fourstep.cu`` TailTile::LAG)
TAIL_LAG = 2


def tail_count(rows: int, rs: tuple) -> int:
    """The tickets of a tail launch over ``rows`` Z rows of radices rs =
    (R1, R2, R3)."""
    r1, r2, r3 = rs
    g = tail_geometry(r2, r3)
    return rows * r1 // (2 * g["H"]) * (g["NP"] + g["NC"])


def tail_item(i: int, rows: int, rs: tuple) -> tuple:
    """Ticket i's work, as the kernel decodes it: ("pass", block, sub),
    pass-2 item sub of block row * R1 + d1, or ("split", tile), the split
    tile that :func:`pass_split_slot` numbers.  The pass-2 items of the
    first :data:`TAIL_LAG` group pairs, then for each pair q those of q +
    TAIL_LAG and the split items of q in turn, then the last pairs' split
    items."""
    r1, r2, r3 = rs
    g = tail_geometry(r2, r3)
    h, n_p = g["H"], g["NP"]
    assert g["NC"] == n_p
    half = r1 // (2 * h)                 # group pairs a row
    pairs = rows * half
    lag = min(pairs, TAIL_LAG)
    if i < lag * n_p:
        kind, (q, u) = "pass", divmod(i, n_p)
    elif i < lag * n_p + (pairs - lag) * 2 * n_p:
        k, r = divmod(i - lag * n_p, 2 * n_p)
        kind, q, u = ("split", k, r // 2) if r % 2 else ("pass", k + lag,
                                                         r // 2)
    else:
        q, u = divmod(i - lag * n_p - (pairs - lag) * 2 * n_p, n_p)
        kind, q = "split", pairs - lag + q
    b, j = divmod(q, half)
    if kind == "pass":
        m, sub = divmod(u, g["per_block"])
        d1 = j * h + m if m < h else (2 * half - 1 - j) * h + m - h
        return "pass", b * r1 + d1, sub
    grp, d2 = (j, u) if u < r2 // 2 else (2 * half - 1 - j, u - r2 // 2)
    return "split", b * (r1 * r2 // (2 * h)) + d2 * (r1 // h) + grp


def tail_items(rows: int, rs: tuple) -> list[tuple]:
    """Every item of a tail launch in ticket order."""
    return [tail_item(i, rows, rs) for i in range(tail_count(rows, rs))]


def tail_reads(tile: int, rs: tuple) -> list[int]:
    """The blocks (row * R1 + d1) split tile ``tile`` waits for: its H
    transforms' blocks, then their mirrors'."""
    r1, r2, r3 = rs
    h = tail_geometry(r2, r3)["H"]
    row, p = divmod(tile * h, r1 * r2 // 2)
    d1 = p % r1
    return ([row * r1 + d1 + i for i in range(h)]
            + [row * r1 + (r1 - d1 - i) % r1 for i in range(h)])


def tail_slot_row(tile: int, f: int, rs: tuple) -> int:
    """Where in Z (rows of N points) the row that split tile ``tile``'s
    slot f reads starts, as the kernel forms it from the tile's digits
    (SlotRows): pair p = d1 + R1 d2 of its row; slot f < H holds transform
    p + f at row ((d1 + f) R2 + d2) R3, slot H + m the mirror of p + m at
    ((R1 - d1 - m) R2 + R2 - 1 - d2) R3, or (R2 - d2) R3 for d1 + m = 0
    (R2/2 for p = 0)."""
    r1, r2, r3 = rs
    h = tail_geometry(r2, r3)["H"]
    row, p = divmod(tile * h, r1 * r2 // 2)
    d1, d2 = p % r1, p // r1
    e1, e2 = d1 + f, d2
    if f >= h:
        m = d1 + f - h
        e1 = (r1 - m) % r1
        e2 = r2 - 1 - d2 if m else (r2 - d2 if d2 else r2 // 2)
    return row * r1 * r2 * r3 + (e1 * r2 + e2) * r3


def tail_group_bytes(rs: tuple) -> int:
    """The bytes the pass-2 items of one group pair write (complex64):
    the distinct blocks of the first group pair's items, N/R1 points
    each."""
    r1, r2, r3 = rs
    g = tail_geometry(r2, r3)
    blocks = {it[1] for it in tail_items(1, rs)[:g["NP"]]}
    return len(blocks) * r2 * r3 * 8


# ---------------------------------------------------------------------------
# The fused column launch (csrc/fourstep.cu fourstep_pass_kernel<RA, RB,
# false, false>, ColTile): both passes of a two-pass column plan over an
# axis of M = RA RB points at stride K of (rows, M K) in one launch.  Pass
# A's transform b K + col (b < RB) reads and writes the points b + RB j of
# column col, pass B's o K + col (o < RA) reads the points RA o + j and
# writes o + RA k: a slab of W adjacent columns of a row is closed under
# both.  Tickets run pass A's items of the first LAG slabs, then for each
# slab q those of q + LAG and pass B's of q in turn, then pass B's of the
# last LAG slabs.
# ---------------------------------------------------------------------------

#: The fused column launch's L2 budget (``csrc/fourstep.cu``
#: ColTile::L2_BUDGET): LAG + 1 slabs in flight.
COLUMN_L2_BYTES = 20 << 20


def column_geometry(ra: int, rb: int) -> dict:
    """The fused column launch's layout at radices (RA, RB): a side's item
    is T = 4096 / R adjacent transforms of R points (E = 16 points a
    thread, TPF threads a transform, the lanes of a warp across FW = 32
    transforms), point-major; W columns a slab (the wider item's), NI
    items a side a slab, the slab's bytes and LAG."""
    def side(r):
        t = 4096 // r
        return {"R": r, "T": t, "E": 16, "TPF": r // 16, "FW": min(t, 32)}
    a, b = side(ra), side(rb)
    w = max(a["T"], b["T"])
    slab = ra * rb * w * 8
    return {"A": a, "B": b, "threads": 256, "W": w, "NI": w // a["T"] * rb,
            "slab_bytes": slab, "LAG": COLUMN_L2_BYTES // slab - 1}


def column_count(rows: int, k: int, rs: tuple) -> int:
    """The tickets of a fused column launch over ``rows`` rows of M K
    points, rs = (RA, RB)."""
    g = column_geometry(*rs)
    return rows * (k // g["W"]) * 2 * g["NI"]


def column_item(i: int, rows: int, k: int, rs: tuple) -> tuple:
    """Ticket i's work, as the kernel decodes it (col_item): (side "A" or
    "B", slab, first transform of that pass's rows * M K / R)."""
    ra, rb = rs
    g = column_geometry(ra, rb)
    ni, w = g["NI"], g["W"]
    slabs = rows * (k // w)
    lag = min(slabs, g["LAG"])
    if i < lag * ni:
        side, (q, u) = "A", divmod(i, ni)
    elif i < lag * ni + (slabs - lag) * 2 * ni:
        r = i - lag * ni
        kk, rr = divmod(r, 2 * ni)
        side = "B" if r % 2 else "A"
        q, u = (kk if side == "B" else kk + lag), rr // 2
    else:
        q, u = divmod(i - lag * ni - (slabs - lag) * 2 * ni, ni)
        side, q = "B", slabs - lag + q
    row, col = divmod(q, k // w)
    t = g[side]["T"]
    d, sub = divmod(u, w // t)
    r_other = rb if side == "A" else ra
    return side, q, (row * r_other + d) * k + col * w + sub * t


def column_items(rows: int, k: int, rs: tuple) -> list[tuple]:
    """Every item of a fused column launch in ticket order."""
    return [column_item(i, rows, k, rs)
            for i in range(column_count(rows, k, rs))]


def column_points(item: tuple, k: int, rs: tuple):
    """(read, written): the points of the (rows, M K) grid that an item
    reads and writes, (T, R) arrays in its buffer's order (transform f,
    point j): pass A in place over columns of stride RB K, pass B from
    columns of stride K into columns of stride RA K."""
    side, _, first = item
    ra, rb = rs
    m = ra * rb
    r = ra if side == "A" else rb
    t = 4096 // r
    g = first + np.arange(t)[:, None]            # the item's transforms
    j = np.arange(r)[None, :]
    row, c = divmod(g, m * k // r)
    base = row * m * k
    if side == "A":
        at = base + c + j * rb * k
        return at, at
    o, col = divmod(c, k)
    return (base + o * rb * k + col + j * k,
            base + c + j * ra * k)


def column_in_flight(rows: int, k: int, rs: tuple) -> int:
    """The most slabs open at once in ticket order: a slab opens with its
    first pass-A ticket and closes with its last pass-B ticket."""
    items = column_items(rows, k, rs)
    first, last = {}, {}
    for i, (side, q, _) in enumerate(items):
        if side == "A":
            first.setdefault(q, i)
        else:
            last[q] = i
    events = sorted([(i, 1) for i in first.values()]
                    + [(i, -1) for i in last.values()])
    open_, most = 0, 0
    for _, d in events:
        open_ += d
        most = max(most, open_)
    return most


# ---------------------------------------------------------------------------
# The row kernels on the same core: c2c_kernel (csrc/c2c.cu) and the R2C
# and C2R kernels (csrc/real.cu, csrc/c2r.cu, at M = L = n/2).  F rows a
# block, TPF threads a row (lane = row * TPF + t), each row's buffers BUF
# elements apart; revblock layouts staged through the row's buffer with
# :func:`stage_pos`.
# ---------------------------------------------------------------------------


def row_stride(base: int, tpf: int) -> int:
    """Elements between two rows' buffers: ``base`` where a warp holds one
    row (TPF >= 32), else padded to TPF mod 16 (8 at TPF = 16), so that
    the rows of a warp meet different banks."""
    if tpf > 16:
        return base
    return base + ((tpf if tpf < 16 else 8) - base) % 16


# the warps an SM each row kernel's fp32 instantiation aims at
ROW_WARPS = {"c2c": 24, "r2c": 32, "c2r": 16}


def row_geometry(m: int, exact: bool = False, warps: int = 24) -> dict:
    """The block layout of an M-point row (``csrc/hcore.cuh``
    RowGeometry<M, EXACT, WARPS>): E = 16 points a thread (32 at M =
    16384), F rows a block (256 threads up to M = 4096, one row of 512
    above), the blocks an SM (MINB: ``warps`` for fp32, 16 for "exact", or
    what the shared memory allows), PAD slots of :func:`pad16` elements,
    two buffers a row (PP) where MINB blocks of them fit an SM, each row's
    buffers BUF elements apart (:func:`row_stride`), the stage twiddle
    table after the rows (TAB entries of the arithmetic type: W^k a stage,
    and the anchors W^(4k) of :func:`anchored_powers` for radix 8 and 16),
    the revblock staging's pad PADR after every 128 positions, the bytes
    of shared memory, and the element size of the shared memory."""
    elem = 16 if exact and m <= 8192 else 8
    celem = 16 if exact else 8
    e = 32 if m >= 16384 else 16
    tpf = m // e
    f = max(1, 256 // tpf)
    slot = pad16(m)
    tab = sum(p * (2 if r >= 8 else 1)
              for r, p in zip(radices(m)[1:], stage_p(m)[1:]))
    by_warps = (16 if exact else warps) * 32 // (f * tpf)
    pp = max(1, by_warps) * (f * row_stride(2 * slot, tpf) * elem
                             + tab * celem + 1024) <= 233472
    buf = row_stride((2 if pp else 1) * slot, tpf)
    smem = f * buf * elem + tab * celem
    cb = max(1, m // 128)
    return {"E": e, "TPF": tpf, "F": f, "threads": f * tpf, "SLOT": slot,
            "PP": pp, "BUF": buf, "TAB": tab, "smem": smem,
            "MINB": max(1, min(233472 // (smem + 1024), by_warps)),
            "CB": cb, "PADR": 1 if cb >= 32 else 32 // cb, "elem": elem}


def revblock_pos(k, c: int):
    """The position of logical element k in a revblock row (k1*c + k2 sits
    at k2*128 + k1)."""
    return (k % c) * 128 + k // c


def revblock_index(p, c: int):
    """The logical element at position p of a revblock row."""
    return (p % 128) * c + p // 128


def stage_pos(p, g: dict):
    """Where the revblock staging keeps position p of a row: PADR pad
    elements after every 128 positions, so that a warp writing consecutive
    positions and a warp reading consecutive logical elements (positions
    128 apart, c of them) both meet every bank evenly."""
    return p + (p // 128) * g["PADR"]


def c2c_rows(x: np.ndarray, inverse: bool = False, rev_in: bool = False,
             rev_out: bool = False, scale: float = 1.0) -> np.ndarray:
    """c2c_kernel on rows x (B, N), its index maps written out: revblock
    input staged by position and read by logical element into the
    registers, the core, the scale on its unrounded outputs, revblock output
    staged by logical element and stored by position."""
    b, m = x.shape
    g = row_geometry(m)
    c = g["CB"]
    rev_in, rev_out = rev_in and c > 1, rev_out and c > 1
    p = np.arange(m)
    if rev_in:
        st = np.zeros((b, stage_pos(m - 1, g) + 1), complex)
        st[:, stage_pos(p, g)] = x                    # coalesced by position
        x = st[:, stage_pos(revblock_pos(p, c), g)]   # point k = t + s*TPF
    y = core(x, g["TPF"], inverse) * scale
    if rev_out:
        st = np.zeros((b, stage_pos(m - 1, g) + 1), complex)
        st[:, stage_pos(revblock_pos(p, c), g)] = y   # the last stage's k
        y = st[:, stage_pos(p, g)]                    # coalesced by position
    return y


REAL_LAYOUTS = ("planar", "planar_rev", "packed", "numpy")


def r2c_rows(x: np.ndarray, layout: str = "planar"):
    """The R2C kernel on real rows x (B, n), its index maps written out:
    z[m] = x[2m] + i x[2m+1] through the L-point core, Z into a free buffer
    in natural order (unpadded: a warp's mirror reads L-k are a run one off
    the padding's blocks of 16), one thread a pair (k, L-k) storing X[k] and
    X[L-k] where the layout puts them; ``planar_rev`` writes X in natural
    order, reads it back into the registers (point t + s*TPF) and stages it
    as :func:`c2c_rows` stages a revblock output.  Returns (the output in
    ``layout``: (B, L) complex, (B, L+1) for numpy; the number of stores
    each output element received)."""
    b, n = x.shape
    L = n // 2
    g = row_geometry(L)
    tpf, e, c = g["TPF"], g["E"], g["CB"]
    w = np.exp(-2j * np.pi * np.arange(L) / n)
    zb = core(x[:, 0::2] + 1j * x[:, 1::2], tpf)
    width = L + 1 if layout == "numpy" else L
    out = np.zeros((b, width), complex)
    hits = np.zeros(width, int)
    rev = layout == "planar_rev" and c > 1

    def store(k, v):
        out[:, k] = v                     # planar_rev: X in place of Z
        if not rev:
            hits[k] += 1

    for t in range(tpf):
        for j in range(e // 2):
            k = t + j * tpf                       # 0 <= k < L/2
            a = zb[:, k]
            if k == 0:
                dc, nyq = a.real + a.imag, a.real - a.imag
                if layout == "numpy":
                    store(0, dc)
                    store(L, nyq)
                else:
                    store(0, dc + 1j * nyq)
                continue
            bb = zb[:, L - k]
            ev = 0.5 * (a + np.conj(bb))
            od = -0.5j * (a - np.conj(bb))
            store(k, ev + w[k] * od)
            store(L - k, np.conj(ev - w[k] * od))
    a = zb[:, L // 2]                             # the self-pair k = L/2
    ev, od = 0.5 * (a + np.conj(a)), -0.5j * (a - np.conj(a))
    store(L // 2, ev + w[L // 2] * od)
    if rev:
        p = np.arange(L)
        st = np.zeros((b, stage_pos(L - 1, g) + 1), complex)
        st[:, stage_pos(revblock_pos(p, c), g)] = out   # point t + s*TPF
        out = st[:, stage_pos(p, g)]                    # by position
        hits += 1
    return out, hits


def c2r_geometry(m: int, exact: bool = False) -> dict:
    """The C2R kernel's block at M = L (``csrc/c2r.cu`` C2rGeometry):
    :func:`row_geometry` at its :data:`ROW_WARPS`, and ``OFF``, where the
    ``planar_rev`` staging starts in a row's buffers (the second buffer
    where there are two)."""
    g = row_geometry(m, exact, ROW_WARPS["c2r"])
    return {**g, "OFF": g["SLOT"] if g["PP"] else 0}


def c2r_rows(spec: np.ndarray, layout: str = "planar", scale: float = 1.0):
    """The C2R kernel on packed half spectra ``spec`` in ``layout`` ((B, L)
    complex, (B, L+1) for numpy), its index maps written out: thread t
    forms Z[m] for the points m = t + s*TPF its first stage takes, in the
    registers, from X[m] and X[L-m] (the natural layouts read both from
    device memory; ``planar_rev`` from the staging, where the block put
    each position p at :func:`stage_pos` (p)), with W_n^m and the scale
    (m = 0 from (DC, Nyquist): slot 0, or the numpy layout's real parts of
    bins 0 and L); the inverse core from the registers, natural z =
    (y[2m], y[2m+1]).  Returns (y (B, n) = scale * L * irfft; how many
    threads formed each point of Z; how many reads each bin of the input
    received)."""
    b, width = spec.shape
    L = width - 1 if layout == "numpy" else width
    n = 2 * L
    g = c2r_geometry(L)
    tpf, e, c = g["TPF"], g["E"], g["CB"]
    w = np.exp(-2j * np.pi * np.arange(L) / n)
    h = 0.5 * scale
    if layout == "planar_rev" and c > 1:
        st = np.zeros((b, stage_pos(L - 1, g) + 1), complex)
        st[:, stage_pos(np.arange(L), g)] = spec       # coalesced by position
        load = lambda k: st[:, stage_pos(revblock_pos(k, c), g)]
    else:
        load = lambda k: spec[:, k]
    # the point of u[s] of thread t, every thread at once, and its mirror
    m = (np.arange(tpf)[:, None] + np.arange(e)[None, :] * tpf).ravel()
    mirror = np.where(m > 0, L - m, L if layout == "numpy" else 0)
    xa, xb = load(m), load(mirror)
    z = h * (xa + np.conj(xb)) + 1j * h * (xa - np.conj(xb)) * np.conj(w[m])
    d = xa[:, 0] if layout != "numpy" else xa[:, 0].real + 1j * xb[:, 0].real
    z[:, 0] = h * (d.real + d.imag) + 1j * h * (d.real - d.imag)  # m = 0
    u = np.zeros((b, L), complex)
    u[:, m] = z
    y = core(u, tpf, inverse=True)
    return (np.stack([y.real, y.imag], axis=-1).reshape(b, n),
            np.bincount(m, minlength=L),
            np.bincount(np.concatenate([m, mirror]), minlength=width))


def _lanes(g: dict):
    """(row, t) of every thread of a row block, rows t-fastest."""
    return [(tid // g["TPF"], tid % g["TPF"]) for tid in range(g["threads"])]


def _warp_waves(g: dict, fn, elem: int, kind: str, lanes=None):
    """(kind, wavefronts) for each warp of the block accessing element
    row * BUF + fn(row, t) (None: the lane does not access)."""
    lanes = _lanes(g) if lanes is None else lanes
    out = []
    for w0 in range(0, len(lanes), 32):
        addrs = []
        for f, t in lanes[w0:w0 + 32]:
            idx = fn(f, t)
            if idx is not None:
                addrs.append((f * g["BUF"] + idx) * elem)
        out.append((kind, wavefronts(addrs, elem)))
    return out


def row_patterns(m: int, exact: bool, kernel: str = "c2c"):
    """(what, wavefronts) of every shared-memory access of one block of
    ``c2c_kernel`` (``kernel="c2c"``: the core, the revblock staging in and
    out), of the R2C kernel at L = m (``"r2c"``: the core, Z into the
    buffer, the pair reads, the ``planar_rev`` staging) or of the C2R
    kernel at L = m (``"c2r"``: the core from the registers, the
    ``planar_rev`` staging by position and its reads of X[p] and X[L-p]),
    under :func:`row_geometry` at the kernel's :data:`ROW_WARPS`
    (:func:`c2r_geometry` for the C2R kernel); plus the stage twiddle
    table's reads (W^k, and W^(4k) for radix 8 and 16)."""
    g = (c2r_geometry(m, exact) if kernel == "c2r"
         else row_geometry(m, exact, ROW_WARPS[kernel]))
    elem, tpf, e, c = g["elem"], g["TPF"], g["E"], g["CB"]
    rl = radices(m)[-1]
    out = []
    for kind, fn in _stage_indices(m, tpf, False):
        out += _warp_waves(g, lambda f, t, fn=fn: pad16(fn(t)), elem,
                           "stage " + kind)
    # the last stage's outputs into shared memory, point k = i + r*M/RL
    lasts = [(q, r) for q in range(e // rl) for r in range(rl)]
    sp = lambda k: stage_pos(revblock_pos(k, c), g)
    if kernel == "c2c" and c > 1:
        for q, r in lasts:
            out += _warp_waves(g, lambda f, t, q=q, r=r:
                               sp(t + q * tpf + r * (m // rl)), elem,
                               "rev out: last stage")
        for j in range(e):  # coalesced by position, element tid + j*THREADS
            out += _warp_waves(g, lambda f, t, j=j: stage_pos(
                (f * tpf + t + j * g["threads"]) % m, g), elem,
                "revblock by position", _stage_rows(g, j))
            out += _warp_waves(g, lambda f, t, j=j: sp(t + j * tpf), elem,
                               "rev in: registers")
    if kernel == "r2c":
        for q, r in lasts:
            out += _warp_waves(g, lambda f, t, q=q, r=r:
                               t + q * tpf + r * (m // rl), elem,
                               "Z out: last stage")
        for j in range(e // 2):
            k = lambda t, j=j: t + j * tpf
            # the lane of k = 0 writes slot 0 alone and reads no mirror
            mirror = lambda t, k=k: m - k(t) if k(t) else None
            for what in ("pair read", "rev: X natural"):
                out += _warp_waves(g, lambda f, t, k=k: k(t), elem,
                                   what + " k")
                out += _warp_waves(g, lambda f, t, mirror=mirror: mirror(t),
                                   elem, what + " L-k")
        if c > 1:
            for j in range(e):
                out += _warp_waves(g, lambda f, t, j=j: t + j * tpf, elem,
                                   "rev: X to registers")
                out += _warp_waves(g, lambda f, t, j=j: sp(t + j * tpf),
                                   elem, "rev out: registers")
                out += _warp_waves(g, lambda f, t, j=j: stage_pos(
                    (f * tpf + t + j * g["threads"]) % m, g), elem,
                    "revblock by position", _stage_rows(g, j))
    if kernel == "c2r":
        out += _c2r_patterns(g, m)
    for r_s, p in zip(radices(m)[1:], stage_p(m)[1:]):
        for q in range(e // r_s):
            for entry in ("W^k", "W^4k")[:2 if r_s >= 8 else 1]:
                out += [("tw " + entry, w) for _, w in _warp_waves(
                    {**g, "BUF": 0}, lambda f, t, q=q, p=p: (t + q * tpf) % p,
                    16 if exact else 8, "tw")]
    return out


def _c2r_patterns(g: dict, m: int):
    """The C2R kernel's accesses besides the core's stages at L = m: the
    ``planar_rev`` staging written by position (element e = tid +
    j*THREADS of the block) and read at the bins each thread merges, X[p]
    (p = t + s*TPF, ascending across a warp) and its mirror X[L-p]
    (descending)."""
    elem, tpf, e, c, off = g["elem"], g["TPF"], g["E"], g["CB"], g["OFF"]
    out = []
    if c == 1:
        return out
    th = g["threads"]
    for j in range(e):
        lanes = [((tid + j * th) // m, tid) for tid in range(th)]
        out += _warp_waves(g, lambda f, tid, j=j: off + stage_pos(
            (tid + j * th) % m, g), elem, "rev in: by position", lanes)
    sp = lambda k: off + stage_pos(revblock_pos(k, c), g)
    for s in range(e):
        out += _warp_waves(g, lambda f, t, s=s: sp(t + s * tpf), elem,
                           "rev in: X[p]")
        out += _warp_waves(g, lambda f, t, s=s: sp((m - t - s * tpf) % m),
                           elem, "rev in: X[L-p]")
    return out


# ---------------------------------------------------------------------------
# The reuse loops on the same core (csrc/multiple.cu): c2c_multiple_kernel
# on c2c_kernel's block, real_multiple_kernel on the R2C kernel's at 24
# warps an SM (two buffers a row).
# ---------------------------------------------------------------------------


# the warps an SM each reuse loop's fp32 instantiation aims at
REUSE_WARPS = {"c2c": 24, "real": 24}


def last_stage_points(m: int, tpf: int) -> np.ndarray:
    """(TPF, E): the point the core's last stage leaves in register u[s] of
    thread t.  Its output r of butterfly i = t + q*TPF is point i + r*M/RL,
    put into u[q + r*E/RL]; that is point t + s*TPF, the point the first
    stage reads from u[s], so one transform's registers are the next one's
    input (the natural hand-off)."""
    e, rl = m // tpf, radices(m)[-1]
    pts = np.zeros((tpf, e), int)
    t = np.arange(tpf)
    for q in range(e // rl):
        for r in range(rl):
            pts[:, q + r * (e // rl)] = t + q * tpf + r * (m // rl)
    return pts


def multiple_rows(x: np.ndarray, loops: int, inverse: bool = False,
                  fb_rev: bool = False, last_rev: bool = False,
                  rev_out: bool = False, scale: float = 1.0,
                  exact: bool = False) -> np.ndarray:
    """c2c_multiple_kernel on rows x (B, N), its hand-offs written out:
    ``loops + 1`` transforms of x * scale, each but the last times
    1/sqrt(N); after transform j < loops the spectrum stays in the
    registers (natural hand-off) or, revblock (``fb_rev``; ``last_rev``
    for the last hand-off), goes from the last stage's epilogue into the
    staging at its position (:func:`stage_pos` of :func:`revblock_pos`)
    and comes back by position, point t + s*TPF into u[s]; the output is
    natural from the registers or, with ``rev_out``, revblock by
    position."""
    b, m = x.shape
    g = row_geometry(m, exact, REUSE_WARPS["c2c"])
    c, tpf = g["CB"], g["TPF"]
    p = np.arange(m)
    u = x * scale
    for it in range(loops + 1):
        last = it == loops
        y = core(u, tpf, inverse) * (1.0 if last else 1.0 / np.sqrt(m))
        rev = c > 1 and (rev_out if last else
                         (last_rev if it + 1 == loops else fb_rev))
        if rev:
            st = np.zeros((b, stage_pos(m - 1, g) + 1), complex)
            st[:, stage_pos(revblock_pos(p, c), g)] = y  # the epilogue's k
            y = st[:, stage_pos(p, g)]                   # by position
        u = y
    return u


def real_multiple_rows(x: np.ndarray, pairs: int):
    """real_multiple_kernel on real rows x (B, n), its index maps written
    out: ``pairs`` round trips, each the forward L-point core (L = n/2) of
    z[m] = x[2m] + i x[2m+1] with Z into the row's buffer in natural order,
    one thread a pair (k, L-k) splitting and at once merging in place with
    W_n^k and the scale 1/L (each thread reads its two bins before it
    writes them), the inverse core from the unpadded buffer, natural z in
    the registers for the next round trip.  Returns (the output (B, n); the
    number of pair threads that wrote each bin in one round trip)."""
    b, n = x.shape
    L = n // 2
    g = row_geometry(L, False, REUSE_WARPS["real"])
    tpf, e = g["TPF"], g["E"]
    w = np.exp(-2j * np.pi * np.arange(L // 2 + 1) / n)
    h = 0.5 / L
    z = x[:, 0::2] + 1j * x[:, 1::2]
    hits = np.zeros(L, int)

    def split_merge(a, bb, wk, self_pair=False):
        ev = 0.5 * (a + np.conj(bb))
        od = -0.5j * (a - np.conj(bb))
        xk, xm = ev + wk * od, np.conj(ev - wk * od)
        if self_pair:  # the kernel merges X[L/2] with itself
            xm = xk
        ev = h * (xk + np.conj(xm))
        od = h * (xk - np.conj(xm)) * np.conj(wk)
        return ev + 1j * od, np.conj(ev - 1j * od)

    for _ in range(pairs):
        buf = core(z, tpf)            # Z, natural, unpadded
        hits[:] = 0
        for t in range(tpf):
            for j in range(e // 2):
                k = t + j * tpf       # 0 <= k < L/2
                if k == 0:
                    dc = buf[:, 0].real + buf[:, 0].imag
                    nyq = buf[:, 0].real - buf[:, 0].imag
                    buf[:, 0] = h * (dc + nyq) + 1j * h * (dc - nyq)
                    hits[0] += 1
                    continue
                buf[:, k], buf[:, L - k] = split_merge(buf[:, k],
                                                       buf[:, L - k], w[k])
                hits[k] += 1
                hits[L - k] += 1
        zh, _ = split_merge(buf[:, L // 2], buf[:, L // 2], w[L // 2],
                            self_pair=True)
        buf[:, L // 2] = zh           # thread 0: the self-pair k = L/2
        hits[L // 2] += 1
        z = core(buf, tpf, inverse=True)
    return np.stack([z.real, z.imag], axis=-1).reshape(b, n), hits


def multiple_patterns(m: int, exact: bool, kernel: str = "c2c"):
    """(what, wavefronts) of the shared-memory accesses the reuse loops add
    to the core's: ``"c2c"`` (M = N): the revblock hand-off's epilogue
    stores (point k at the staging position of revblock_pos(k)) and its
    reads by position (point t + s*TPF); ``"real"`` (M = L): Z out of the
    last stage, the pair step's reads and writes of k and L-k and of W_n^k
    from the block table, and the inverse's first stage reading the
    unpadded row."""
    g = row_geometry(m, exact, REUSE_WARPS[kernel])
    elem, tpf, e, c = g["elem"], g["TPF"], g["E"], g["CB"]
    rl = radices(m)[-1]
    out = []
    if kernel == "c2c":
        for q in range(e // rl):
            for r in range(rl):
                out += _warp_waves(g, lambda f, t, q=q, r=r: stage_pos(
                    revblock_pos(t + q * tpf + r * (m // rl), c), g), elem,
                    "hand-off: last stage")
        for s in range(e):
            out += _warp_waves(g, lambda f, t, s=s: stage_pos(t + s * tpf, g),
                               elem, "hand-off: registers")
        return out
    return out + _pair_patterns(g, m, elem)


def _pair_patterns(g: dict, m: int, welem: int | None):
    """(what, wavefronts) of a real round trip's row accesses at L = m
    (the real reuse loop, the real convolution): Z out of the last stage
    (unpadded), the pair step's reads and writes of k (ascending) and L-k
    (descending), W_n^k from the block table (``welem`` bytes an entry;
    None: read from device memory), and the inverse's first stage reading
    the unpadded row."""
    elem, tpf, e = g["elem"], g["TPF"], g["E"]
    rl = radices(m)[-1]
    out = []
    for q in range(e // rl):
        for r in range(rl):
            out += _warp_waves(g, lambda f, t, q=q, r=r:
                               t + q * tpf + r * (m // rl), elem,
                               "Z out: last stage")
    for j in range(e // 2):
        k = lambda t, j=j: t + j * tpf
        mirror = lambda t, k=k: m - k(t) if k(t) else None
        out += _warp_waves(g, lambda f, t, k=k: k(t), elem, "pair k")
        out += _warp_waves(g, lambda f, t, mirror=mirror: mirror(t), elem,
                           "pair L-k")
        if welem:
            out += _warp_waves({**g, "BUF": 0}, lambda f, t, k=k: k(t),
                               welem, "W_n^k")
    for q in range(e // 16):
        for r in range(16):
            out += _warp_waves(g, lambda f, t, q=q, r=r:
                               t + q * tpf + r * (m // 16), elem,
                               "inverse: first stage")
    return out


# ---------------------------------------------------------------------------
# The fused convolutions on the same core (csrc/conv.cu): conv_kernel on
# c2c_kernel's block at M = N, conv_real_kernel on the R2C kernel's at M =
# L = n/2; the banks (m > 1) are instantiations of their own.
# ---------------------------------------------------------------------------


# the warps an SM the fp32 instantiations aim at (conv.cu's CONV_WARPS)
CONV_WARPS = 16


def conv_geometry(m: int, exact: bool = False, real: bool = False) -> dict:
    """The block of a convolution instantiation at M = m (N, or L for the
    real kernel), single-filter and bank alike: :func:`row_geometry` at
    :data:`CONV_WARPS`; the real
    kernel adds W_n^k, k <= L/2, after the stage table where the block
    still fits (``wk_shared``; the "exact" tier at L = 8192 reads it from
    device memory), and its blocks an SM are the row geometry's where
    they still fit (``conv.cu``'s ConvReal)."""
    g = row_geometry(m, exact, CONV_WARPS)
    if not real:
        return {**g, "wk_shared": False}
    wk = (m // 2 + 1) * (16 if exact else 8)
    shared = g["smem"] + wk <= 232448
    smem = g["smem"] + (wk if shared else 0)
    return {**g, "wk_shared": shared, "smem": smem,
            "MINB": max(1, min(g["MINB"], 233472 // (smem + 1024)))}


def conv_rows(x: np.ndarray, h: np.ndarray, h_at=None) -> np.ndarray:
    """conv_kernel on rows x (B, N) against responses h (m, N) (1/N folded
    in), its index maps written out: the forward core; the registers
    after its last stage, u[s] of thread t holding point
    :func:`last_stage_points` [t, s], each multiplied in the epilogue by H
    at ``h_at(t, s)`` (the kernel: t + s*TPF, the point it holds); the
    inverse core reading u[s] of thread t as its point t + s*TPF.  m = 1
    runs the product in the forward core's epilogue; the bank keeps the
    spectrum registers and runs the product and the inverse once a filter.
    Returns (m, B, N)."""
    b, n = x.shape
    g = conv_geometry(n)
    tpf, e = g["TPF"], g["E"]
    t, s = np.arange(tpf)[:, None], np.arange(e)[None, :]
    pts = last_stage_points(n, tpf)
    at = t + s * tpf if h_at is None else h_at(t, s)
    spec = core(x, tpf)[:, pts]                 # (B, TPF, E): the registers
    out = np.zeros((h.shape[0], b, n), complex)
    for j in range(h.shape[0]):
        u = np.zeros((b, n), complex)
        u[:, t + s * tpf] = spec * h[j][at]     # read as point t + s*TPF
        out[j] = core(u, tpf, inverse=True)
    return out


def conv_real_rows(x: np.ndarray, h: np.ndarray):
    """conv_real_kernel on real rows x (B, n) against packed half responses
    h (m, L) (slot 0 = (Re H[0], Re H[L]), 1/L folded in), its index maps
    written out: z[m] = x[2m] + i x[2m+1] through the L-point core, Z into
    the row's buffer (natural, unpadded); one thread a pair (k, L-k), k =
    t + p*TPF < L/2, splitting it with W_n^k (the bank: once, kept for
    every filter), multiplying X[k] by H[k] and X[L-k] by H[L-k] and
    merging the products at h = 1/2 back into bins k and L-k; slot 0 as
    two real products (DC, Nyquist); thread 0 the self-pair k = L/2 with
    H[L/2] once; the inverse core from the buffer, natural z = (y[2m],
    y[2m+1]).  Returns (y (m, B, n); for each bin of one filter's pair
    step, how many pair threads wrote it; whether each thread read only
    the bins it wrote)."""
    b, n = x.shape
    L = n // 2
    g = conv_geometry(L, real=True)
    tpf, e = g["TPF"], g["E"]
    w = np.exp(-2j * np.pi * np.arange(L // 2 + 1) / n)
    zb = core(x[:, 0::2] + 1j * x[:, 1::2], tpf)   # Z, natural, unpadded

    def split(a, c, wk):
        ev, od = 0.5 * (a + np.conj(c)), -0.5j * (a - np.conj(c))
        return ev + wk * od, np.conj(ev - wk * od)

    def merge(a, c, wk):  # at h = 1/2: the scale 1/L is in H
        ev = 0.5 * (a + np.conj(c))
        od = 0.5 * (a - np.conj(c)) * np.conj(wk)
        return ev + 1j * od, np.conj(ev - 1j * od)

    # the split, thread by thread: xs[(t, k)] = (X[k], X[L-k]); slot 0
    # (DC, Nyquist) as two reals
    xs, reads = {}, {}
    for t in range(tpf):
        for p in range(e // 2):
            k = t + p * tpf
            if k == 0:
                a = zb[:, 0]
                xs[t, 0] = (a.real + a.imag, a.real - a.imag)
                reads.setdefault(t, set()).add(0)
                continue
            xs[t, k] = split(zb[:, k], zb[:, L - k], w[k])
            reads.setdefault(t, set()).update({k, L - k})
    xs[0, L // 2] = split(zb[:, L // 2], zb[:, L // 2], w[L // 2])
    reads[0].add(L // 2)

    out = np.zeros((h.shape[0], b, n))
    hits = np.zeros(L, int)
    writes = {}
    for j in range(h.shape[0]):
        buf = np.full((b, L), np.nan, complex)
        hits[:] = 0
        for (t, k), (xk, xm) in xs.items():
            if k == 0:
                dc, nyq = xk * h[j, 0].real, xm * h[j, 0].imag
                buf[:, 0] = 0.5 * (dc + nyq) + 0.5j * (dc - nyq)
                done = (0,)
            elif k == L // 2:               # its own mirror: H[L/2] once
                gk = xk * h[j, k]
                buf[:, k], _ = merge(gk, gk, w[k])
                done = (k,)
            else:
                buf[:, k], buf[:, L - k] = merge(xk * h[j, k],
                                                 xm * h[j, L - k], w[k])
                done = (k, L - k)
            for d in done:
                hits[d] += 1
                writes.setdefault(t, set()).add(d)
        z = core(buf, tpf, inverse=True)
        out[j] = np.stack([z.real, z.imag], axis=-1).reshape(b, n)
    return out, hits, all(reads[t] == writes[t] for t in reads)


def conv_patterns(m: int, exact: bool, kernel: str = "conv"):
    """(what, wavefronts) of a convolution block's shared-memory accesses
    at M = m: the core's stages under :func:`conv_geometry` (both kernels),
    and for ``"conv_real"`` (M = L) the round trip's row accesses of
    :func:`_pair_patterns` with W_n^k from the block table where it has
    one; plus the stage table's reads."""
    real = kernel == "conv_real"
    g = conv_geometry(m, exact, real)
    out = []
    for kind, fn in _stage_indices(m, g["TPF"], False):
        out += _warp_waves(g, lambda f, t, fn=fn: pad16(fn(t)), g["elem"],
                           "stage " + kind)
    if real:
        out += _pair_patterns(g, m, (16 if exact else 8)
                              if g["wk_shared"] else None)
    for r_s, p in zip(radices(m)[1:], stage_p(m)[1:]):
        for q in range(g["E"] // r_s):
            out += [("tw", w) for _, w in _warp_waves(
                {**g, "BUF": 0}, lambda f, t, q=q, p=p:
                (t + q * g["TPF"]) % p, 16 if exact else 8, "tw")]
    return out


def anchored_powers(w: complex, w4: complex, radix: int) -> list:
    """w^r, r = 0..radix-1, as ``hcore.cuh``'s twiddle_anchored forms them
    from the two table entries w and w4 = w^4: w^(4a+b) = (w^4)^a w^b."""
    lo = [1, w, w * w, w * w * w]
    hi = [1, w4, w4 * w4, w4 * w4 * w4]
    return [hi[r >> 2] * lo[r & 3] for r in range(radix)]


def _stage_rows(g: dict, j: int):
    """The lanes of the coalesced staging loop, element e = tid + j*THREADS
    of the block: row e / M, and t = tid % TPF as the index carrier."""
    m = g["TPF"] * g["E"]
    return [((tid + j * g["threads"]) // m, tid % g["TPF"])
            for tid in range(g["threads"])]
