"""smfft_tpu_torch.parallel against smfft_tpu.parallel on the CPU.

The same inputs, made by numpy from a seed, go through the JAX functions
on a d-device virtual CPU mesh (``backend="xla"``; one case a mesh size
with ``backend="pallas"`` in interpret mode) and through the port in a
d-rank gloo world of spawned processes (the plain versions: CPU shards).
Each world is spawned once per mesh size and runs every case; the tests
read its results.  Bars: the port within 1e-4 * max|JAX| of the JAX
package, and each within the JAX tests' own bars of float64 numpy
(tests/test_sharding.py, tests/test_fourstep.py).
"""

import ast
import re
from pathlib import Path

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
from jax.sharding import Mesh

import smfft_tpu.parallel as JP
from smfft_tpu.parallel import distributed as JD
from smfft_tpu.parallel import sharding as JS
import smfft_tpu_torch.parallel as TP
from smfft_tpu_torch import api
from smfft_tpu_torch.parallel import distributed as TD
from smfft_tpu_torch.parallel.dryrun import dryrun_multichip, run_calls, \
    spawn_world

ROOT = Path(__file__).resolve().parents[1]
SIZES = (4, 8)
B = 32           # batch rows of the sharded cases (divisible by 4 and 8)
N_SMALL, N_MID = 1 << 10, 1 << 17


def c64(rng, *shape):
    return (rng.random(shape) - 0.5
            + 1j * (rng.random(shape) - 0.5)).astype(np.complex64)


def f32(rng, *shape):
    return (rng.random(shape) - 0.5).astype(np.float32)


def unpack(h):
    """Packed half-spectrum (slot 0 = DC + i*Nyq) -> numpy rfft layout."""
    full = np.concatenate([h[..., :1].real, h[..., 1:],
                           h[..., :1].imag], axis=-1).astype(np.complex128)
    return full


def c_layout(v, n1, n2):
    """X (..., N) -> the C-matrix C[k1, k2] = X[k2*n1 + k1]."""
    return np.swapaxes(v.reshape(v.shape[:-1] + (n2, n1)), -1, -2)


class Case:
    """One call in the world: the port's call, the JAX reference, the
    float64 oracle and its bar, and the placements the output must have."""

    def __init__(self, key, fn, args, kwargs=None, axis="fft", jax=None,
                 oracle=None, bar=None, placements=None, raises=False,
                 gather=True):
        self.call = dict(key=key, fn=fn, args=args, kwargs=kwargs or {},
                         axis=axis, raises=raises, gather=gather)
        self.key, self.jax, self.oracle, self.bar = key, jax, oracle, bar
        self.placements = placements


def cases(d):
    """Every case at mesh size d, in the order the world runs them."""
    rng = np.random.default_rng(1234 + d)
    out = []
    S0, S1 = ["Shard(dim=0)"], ["Shard(dim=1)"]

    # ---- batch sharding (sharding.py) ----
    x = c64(rng, B, 256)
    x128 = x.astype(np.complex128)
    out.append(Case("sharded_fft", "sharded_fft", [x, "MESH"], axis="batch",
                    jax=lambda m: JP.sharded_fft(jnp.array(x), m,
                                                 backend="xla"),
                    oracle=np.fft.fft(x128), bar=("abs", 1e-4),
                    placements=S0))
    out.append(Case("sharded_ifft", "sharded_fft", [x, "MESH"],
                    {"inverse": True}, axis="batch",
                    jax=lambda m: JP.sharded_fft(jnp.array(x), m,
                                                 inverse=True,
                                                 backend="xla"),
                    oracle=np.fft.ifft(x128), bar=("abs", 1e-5),
                    placements=S0))
    # unordered: the revblock layout, against the Pallas kernel (interpret)
    out.append(Case("sharded_fft_unordered", "sharded_fft", [x, "MESH"],
                    {"ordered": False}, axis="batch", jax="pallas",
                    placements=S0))
    out.append(Case("sharded_ifft_unordered", "sharded_fft", [x, "MESH"],
                    {"inverse": True, "ordered": False}, axis="batch",
                    placements=S0))
    out.append(Case("sharded_roundtrip", "sharded_fft",
                    [("ref", "sharded_fft"), "MESH"], {"inverse": True},
                    axis="batch", oracle=x128, bar=("abs", 1e-5),
                    placements=S0))
    xr = f32(rng, B, 512)
    out.append(Case("sharded_rfft", "sharded_rfft", [xr, "MESH"],
                    axis="batch",
                    jax=lambda m: JS.sharded_rfft(jnp.array(xr), m,
                                                  backend="xla"),
                    oracle=np.fft.rfft(xr.astype(np.float64)),
                    bar=("abs", 1e-4), placements=S0))
    spec = np.fft.rfft(xr.astype(np.float64)).astype(np.complex64)
    out.append(Case("sharded_irfft", "sharded_irfft", [spec, "MESH", 512],
                    axis="batch",
                    jax=lambda m: JS.sharded_irfft(jnp.array(spec), m, 512,
                                                   backend="xla"),
                    oracle=xr, bar=("abs", 1e-4), placements=S0))
    h1 = c64(rng, 256)
    out.append(Case("sharded_convolve", "sharded_convolve",
                    [x, h1, "MESH"], axis="batch",
                    jax=lambda m: JP.sharded_convolve(
                        jnp.array(x), jnp.array(h1), m, backend="xla"),
                    oracle=np.fft.ifft(np.fft.fft(x128) * h1),
                    bar=("abs", 1e-4), placements=S0))
    hb = c64(rng, 2, 256)
    out.append(Case("sharded_convolve_bank", "sharded_convolve",
                    [x, hb, "MESH"], axis="batch",
                    jax=lambda m: JP.sharded_convolve(
                        jnp.array(x), jnp.array(hb), m, backend="xla"),
                    oracle=np.fft.ifft(np.fft.fft(x128)[None]
                                       * hb.astype(np.complex128)[:, None]),
                    bar=("abs", 1e-4), placements=S1))
    out.append(Case("shard_batch", "shard_batch", [xr, "MESH"],
                    {"axis_name": "batch"}, axis="batch", oracle=xr,
                    bar=("abs", 0.0), placements=S0))
    ragged = c64(rng, B + 1, 256)
    out.append(Case("sharded_fft_ragged", "sharded_fft", [ragged, "MESH"],
                    axis="batch", raises=True,
                    jax=lambda m: JP.sharded_fft(jnp.array(ragged), m,
                                                 backend="xla")))

    # ---- the distributed four-step (distributed.py) ----
    for n in (N_SMALL, N_MID):
        v = c64(rng, n)
        out.append(Case(f"dfft_{n}", "distributed_fft", [v, "MESH"],
                        jax=lambda m, v=v: JP.distributed_fft(
                            jnp.array(v), m, backend="xla"),
                        oracle=np.fft.fft(v.astype(np.complex128)),
                        bar=("rel", 2e-6), placements=S0))
    out.append(Case("dfft_roundtrip", "distributed_ifft",
                    [("ref", f"dfft_{N_MID}"), "MESH"],
                    oracle=None, bar=("rel", 2e-6), placements=S0))
    nt = 1 << 16
    n1, n2 = TD.plan_distributed(nt, d)
    vt = c64(rng, nt)
    want_t = np.fft.fft(vt.astype(np.complex128))
    out.append(Case("dfft_transposed", "distributed_fft", [vt, "MESH"],
                    {"transposed_output": True},
                    jax=lambda m: JP.distributed_fft(
                        jnp.array(vt), m, backend="xla",
                        transposed_output=True),
                    oracle=c_layout(want_t, n1, n2), bar=("rel", 2e-6),
                    placements=S0))
    out.append(Case("dfft_transposed_roundtrip", "distributed_ifft",
                    [("ref", "dfft_transposed"), "MESH"],
                    {"transposed_input": True},
                    jax=lambda m: JP.distributed_ifft(
                        JP.distributed_fft(jnp.array(vt), m, backend="xla",
                                           transposed_output=True),
                        m, backend="xla", transposed_input=True),
                    oracle=vt.astype(np.complex128), bar=("rel", 2e-6),
                    placements=S0))
    hf = (rng.random(nt) - 0.5).astype(np.complex64)
    h_c = np.ascontiguousarray(c_layout(hf, n1, n2))
    out.append(Case("dfft_spectral_filter", "distributed_ifft",
                    [("refmul", "dfft_transposed", h_c), "MESH"],
                    {"transposed_input": True},
                    jax=lambda m: JP.distributed_ifft(
                        JP.distributed_fft(jnp.array(vt), m, backend="xla",
                                           transposed_output=True)
                        * jnp.array(h_c), m, backend="xla",
                        transposed_input=True),
                    oracle=np.fft.ifft(want_t * hf), bar=("rel", 2e-6),
                    placements=S0))
    vb = (rng.standard_normal((3, nt))
          + 1j * rng.standard_normal((3, nt))).astype(np.complex64)
    out.append(Case("dfft_batched", "distributed_fft", [vb, "MESH"],
                    jax=lambda m: JP.distributed_fft(jnp.array(vb), m,
                                                     backend="xla"),
                    oracle=np.fft.fft(vb.astype(np.complex128), axis=-1),
                    bar=("rel", 2e-6), placements=S1))
    out.append(Case("dfft_batched_back", "distributed_ifft",
                    [("ref", "dfft_batched"), "MESH"], {"norm": "backward"},
                    oracle=vb.astype(np.complex128), bar=("abs", 1e-5),
                    placements=S1))
    out.append(Case("dfft_batched_transposed", "distributed_fft",
                    [vb[:2], "MESH"], {"transposed_output": True},
                    oracle=c_layout(np.fft.fft(
                        vb[:2].astype(np.complex128), axis=-1), n1, n2),
                    bar=("rel", 2e-6), placements=S1))
    out.append(Case("dfft_batched_transposed_back", "distributed_ifft",
                    [("ref", "dfft_batched_transposed"), "MESH"],
                    {"transposed_input": True, "norm": "backward"},
                    oracle=vb[:2].astype(np.complex128), bar=("abs", 1e-5),
                    placements=S1))
    out.append(Case("difft_raw", "distributed_ifft", [vt, "MESH"],
                    {"norm": None},
                    jax=lambda m: JP.distributed_ifft(jnp.array(vt), m,
                                                      backend="xla",
                                                      norm=None),
                    oracle=np.fft.ifft(vt.astype(np.complex128)) * nt,
                    bar=("rel", 2e-6), placements=S0))
    xrb = rng.standard_normal((2, N_MID)).astype(np.float32)
    out.append(Case("drfft_batched", "distributed_rfft", [xrb, "MESH"],
                    jax=lambda m: JP.distributed_rfft(jnp.array(xrb), m,
                                                      backend="xla"),
                    oracle=np.fft.rfft(xrb.astype(np.float64), axis=-1),
                    bar=("rel", 2e-6), placements=S1))
    out.append(Case("dirfft_batched", "distributed_irfft",
                    [("ref", "drfft_batched"), "MESH"],
                    oracle=xrb, bar=("abs", 1e-5), placements=S1))
    out.append(Case("drfft_of_dtensor", "distributed_rfft",
                    [("ref", "dirfft_batched"), "MESH"],
                    oracle=np.fft.rfft(xrb.astype(np.float64), axis=-1),
                    bar=("rel", 2e-6), placements=S1))
    xv = rng.standard_normal(nt).astype(np.float32)
    out.append(Case("drfft_vector", "distributed_rfft", [xv, "MESH"],
                    jax=lambda m: JP.distributed_rfft(jnp.array(xv), m,
                                                      backend="xla"),
                    oracle=np.fft.rfft(xv.astype(np.float64)),
                    bar=("rel", 2e-6), placements=S0))
    out.append(Case("dirfft_vector", "distributed_irfft",
                    [("ref", "drfft_vector"), "MESH"],
                    jax=lambda m: JP.distributed_irfft(
                        JP.distributed_rfft(jnp.array(xv), m, backend="xla"),
                        m, backend="xla"),
                    oracle=xv, bar=("abs", 1e-5), placements=S0))
    hp = np.fft.rfft(xv.astype(np.float64))
    hpk = np.concatenate([[hp[0].real + 1j * hp[-1].real],
                          hp[1:-1]]).astype(np.complex64)
    out.append(Case("dirfft_raw", "distributed_irfft", [hpk, "MESH"],
                    {"normalize": False},
                    jax=lambda m: JP.distributed_irfft(
                        jnp.array(hpk), m, backend="xla", normalize=False),
                    oracle=xv * (nt // 2), bar=("rel", 2e-6),
                    placements=S0))
    # the all-to-all helper on each rank's row block of (2, 8d, 16d)
    blocks = c64(rng, 2, 8 * d, 16 * d)
    for swap in (False, True):
        out.append(Case(f"all_to_all_swap{swap}", "_all_to_all",
                        [("block", blocks, 1), "MESH", "fft"],
                        {"swap": swap}))
    # a DTensor gathered whole, and re-blocked along another dim
    out.append(Case("full_of_transposed", "_full",
                    [("ref", "dfft_transposed")]))
    out.append(Case("block_of_transposed", "_block",
                    [("ref", "dfft_transposed"), "MESH", "fft", 1]))
    # errors: the mesh axis, the norm the JAX inverse reads as None (C.3)
    out.append(Case("mesh_axis_error", "distributed_fft", [vt, "MESH"],
                    {"axis_name": "batch"}, raises=True,
                    jax=lambda m: JD._mesh_size(m, "batch")))
    out.append(Case("ortho_error", "distributed_ifft", [vt, "MESH"],
                    {"norm": "ortho"}, raises=True))
    out.append(Case("sharded_irfft_ortho_error", "sharded_irfft",
                    [spec, "MESH", 512], {"norm": "ortho"}, axis="batch",
                    raises=True))
    out.append(Case("transposed_both_error", "_dist_c2c",
                    [vt.reshape(n1, n2), "MESH"],
                    dict(inverse=True, transposed_input=True,
                         transposed_output=True, backend="auto",
                         precision=None, norm=None, axis_name="fft"),
                    raises=True))
    return out


CASES = {d: {c.key: c for c in cases(d)} for d in SIZES}


@pytest.fixture(scope="module", params=SIZES, ids=lambda d: f"d{d}")
def world(request, tmp_path_factory):
    """The port's results of every case in one d-rank gloo world."""
    d = request.param
    calls = [c.call for c in CASES[d].values()]
    workdir = str(tmp_path_factory.mktemp(f"world{d}"))
    ranks = spawn_world(d, run_calls, (calls,), workdir=workdir,
                        timeout=240)
    return d, ranks


_JAX_CACHE = {}


def jax_ref(d, key):
    """The JAX package's output of case ``key`` on a d-device mesh."""
    if (d, key) not in _JAX_CACHE:
        case = CASES[d][key]
        devices = np.array(jax.devices()[:d])
        mesh = Mesh(devices, (case.call["axis"],))
        if case.jax == "pallas":
            import smfft_tpu.ops.pallas_c2c as PC
            x = case.call["args"][0]
            PC.set_interpret(True)
            try:
                y = JP.sharded_fft(jnp.array(x), mesh, ordered=False,
                                   backend="pallas")
                _JAX_CACHE[d, key] = (np.asarray(y),
                                      len(y.sharding.device_set))
            finally:
                PC.set_interpret(False)
        else:
            y = case.jax(mesh)
            _JAX_CACHE[d, key] = (np.asarray(y), len(y.sharding.device_set))
    return _JAX_CACHE[d, key]


def out(world, key):
    return world[1][0]["calls"][key]


def err(got, want, kind):
    diff = np.max(np.abs(np.asarray(got, np.complex128)
                         - np.asarray(want, np.complex128)))
    return diff / np.max(np.abs(want)) if kind == "rel" else diff


# ---------------------------------------------------------------------------
# Every output against the JAX package and float64 numpy
# ---------------------------------------------------------------------------

AGAINST_JAX = sorted(k for k, c in CASES[4].items()
                     if c.jax is not None and not c.call["raises"])
AGAINST_NUMPY = sorted(k for k, c in CASES[4].items()
                       if c.bar is not None)


@pytest.mark.parametrize("key", AGAINST_JAX)
def test_port_matches_jax(world, key):
    d = world[0]
    want, ndev = jax_ref(d, key)
    got = out(world, key)["full"]
    assert got.shape == want.shape
    assert ndev == d
    assert err(got, want, "abs") <= 1e-4 * np.max(np.abs(want))


@pytest.mark.parametrize("key", AGAINST_NUMPY)
def test_against_float64(world, key):
    d = world[0]
    case = CASES[d][key]
    got = out(world, key)["full"]
    want = case.oracle
    if want is None:   # the round trip of dfft_{N_MID}: x itself
        want = CASES[d][f"dfft_{N_MID}"].call["args"][0]
    if key.startswith("drfft"):
        got = unpack(got)
    kind, bar = case.bar
    assert err(got, want, kind) <= bar


@pytest.mark.parametrize("key", sorted(k for k, c in CASES[4].items()
                                       if c.placements))
def test_placements_and_mesh_size(world, key):
    """Every DTensor output: its placement, mesh size, global shape and
    the even local block each rank holds on the CPU."""
    d, ranks = world
    case = CASES[d][key]
    for rank in ranks:
        rec = rank["calls"][key]
        assert rec["placements"] == case.placements
        assert rec["mesh_size"] == d
        assert rec["local_device"] == "cpu"
        dim = int(case.placements[0][-2])
        local = list(rec["shape"])
        local[dim] //= d
        assert list(rec["local_shape"]) == local
    assert out(world, key)["full"].shape == tuple(ranks[0]["calls"][key]
                                                  ["shape"])


def test_unordered_is_the_port_revblock_layout(world):
    """ordered=False: each rank's rows in the port's revblock layout (the
    single-process api.fft), forward and inverse."""
    d = world[0]
    x = torch.from_numpy(CASES[d]["sharded_fft_unordered"].call["args"][0])
    for key, want in (("sharded_fft_unordered", api.fft(x, ordered=False)),
                      ("sharded_ifft_unordered",
                       api.ifft(x, ordered=False))):
        got = out(world, key)["full"]
        assert err(got, want.numpy(), "abs") <= 1e-6 * want.abs().max()


def test_all_to_all_matches_the_jax_collective(world):
    """The exchange helper against lax.all_to_all(split_axis=2,
    concat_axis=1, tiled=True) under shard_map, rank by rank; with swap,
    the same blocks transposed."""
    from jax.sharding import PartitionSpec as PSpec
    d, ranks = world
    blocks = CASES[d]["all_to_all_swapFalse"].call["args"][0][1]
    mesh = Mesh(np.array(jax.devices()[:d]), ("fft",))
    mapped = JS._shard_map(
        lambda b: jax.lax.all_to_all(b, "fft", split_axis=2, concat_axis=1,
                                     tiled=True),
        mesh, (PSpec(None, "fft", None),), PSpec(None, None, "fft"))
    want = np.asarray(jax.jit(mapped)(jnp.array(blocks)))
    c = want.shape[-1] // d
    for r, rank in enumerate(ranks):
        mine = want[..., r * c:(r + 1) * c]
        got = rank["calls"]["all_to_all_swapFalse"]["local"]
        np.testing.assert_array_equal(got, mine)
        swapped = rank["calls"]["all_to_all_swapTrue"]["local"]
        np.testing.assert_array_equal(swapped, np.swapaxes(mine, -1, -2))


def test_gather_and_reblock(world):
    """_full: every rank holds the whole C-matrix (c10d all_gather);
    _block of the k1-row-sharded matrix along dim 1: the rank's column
    block, gathered and sliced."""
    d, ranks = world
    whole = out(world, "dfft_transposed")["full"]
    c = whole.shape[1] // d
    for r, rank in enumerate(ranks):
        np.testing.assert_array_equal(
            rank["calls"]["full_of_transposed"]["local"], whole)
        np.testing.assert_array_equal(
            rank["calls"]["block_of_transposed"]["local"],
            whole[:, r * c:(r + 1) * c])


def test_launch_counts_on_the_cpu(world):
    """On CPU shards no kernel launches: every count stays 0."""
    for rank in world[1]:
        assert not any(rank["counts"].values())


# ---------------------------------------------------------------------------
# Errors, word for word where the JAX package has the same one
# ---------------------------------------------------------------------------


def test_mesh_axis_error_text(world):
    d = world[0]
    kind, text = out(world, "mesh_axis_error")["error"]
    mesh = Mesh(np.array(jax.devices()[:d]), ("fft",))
    with pytest.raises(ValueError) as e:
        JD._mesh_size(mesh, "batch")
    assert (kind, text) == ("ValueError", str(e.value))


def test_ragged_batch_raises_as_jax_does(world):
    """B % d != 0: JAX's device_put raises ValueError "... should be
    divisible by d, but it is equal to B ..."; the port raises the same
    type, naming the same numbers."""
    d = world[0]
    kind, text = out(world, "sharded_fft_ragged")["error"]
    with pytest.raises(ValueError) as e:
        jax_ref(d, "sharded_fft_ragged")
    assert kind == "ValueError"
    for s in (f"divisible by {d}", f"equal to {B + 1}"):
        assert s in text and s in str(e.value)


def test_ortho_raises_where_jax_reads_raw(world):
    """C.3 carried into distributed_ifft: the JAX inverse reads "ortho" as
    the raw inverse (N x numpy's backward result); the port raises."""
    d = world[0]
    kind, text = out(world, "ortho_error")["error"]
    assert kind == "ValueError" and "'ortho'" in text
    mesh = Mesh(np.array(jax.devices()[:d]), ("fft",))
    v = CASES[d]["ortho_error"].call["args"][0]
    y = np.asarray(JP.distributed_ifft(jnp.array(v), mesh, norm="ortho",
                                       backend="xla"))
    want = np.fft.ifft(v.astype(np.complex128)) * v.shape[-1]
    assert err(y, want, "rel") < 2e-6


def test_sharded_irfft_ortho_raises(world):
    """sharded_irfft keeps the port's irfft contract (C.3): "ortho"
    raises, where the JAX package returns the raw inverse."""
    kind, text = out(world, "sharded_irfft_ortho_error")["error"]
    assert kind == "ValueError" and "'ortho'" in text


def test_transposed_both_error(world):
    kind, text = out(world, "transposed_both_error")["error"]
    assert kind == "ValueError"
    assert text.startswith("transposed_input with transposed_output")


@pytest.mark.parametrize("n,d", [(1 << 20, 8), (1 << 10, 4), (1 << 10, 8),
                                 (1 << 17, 8), (1 << 28, 32), (1024, 64),
                                 (1 << 11, 64), (1 << 15, 512)])
def test_plan_distributed(n, d):
    """The same factors, or the same error word for word."""
    try:
        want = JD.plan_distributed(n, d)
    except ValueError as e:
        with pytest.raises(ValueError) as got:
            TD.plan_distributed(n, d)
        assert str(got.value) == str(e)
        assert str(got.value).startswith("Error wrong FFT length!")
    else:
        assert TD.plan_distributed(n, d) == want


@pytest.mark.parametrize("n", [1000, 512, 1 << 29])
def test_plan_distributed_size_errors(n):
    with pytest.raises(ValueError) as e:
        JD.plan_distributed(n, 4)
    with pytest.raises(ValueError) as got:
        TD.plan_distributed(n, 4)
    assert str(got.value) == str(e.value)


def test_dryrun_multichip(tmp_path, capsys):
    """The three phases in 4 spawned gloo ranks; the same three lines as
    the JAX dry run (MULTICHIP_r05.json), with the port's numbers."""
    lines = dryrun_multichip(4, workdir=str(tmp_path))
    printed = capsys.readouterr().out.splitlines()
    assert printed == lines and len(lines) == 3
    assert lines[0] == ("dryrun_multichip(4): step ran; output sharded "
                        "over 4 devices")
    for line in lines[1:]:
        assert float(re.search(r"err ([0-9.e+-]+)\)", line).group(1)) < 1e-4


def test_failed_rank_fails_the_world(tmp_path):
    """A rank that raises fails the whole call with its traceback."""
    calls = [dict(key="bad", fn="distributed_fft",
                  args=[np.zeros(1000, np.complex64), "MESH"])]
    with pytest.raises(RuntimeError, match="wrong FFT length"):
        spawn_world(2, run_calls, (calls,), workdir=str(tmp_path),
                    timeout=120)


# ---------------------------------------------------------------------------
# The names and signatures, by AST
# ---------------------------------------------------------------------------


def imported_names(package):
    """The names parallel/__init__.py imports from its submodules."""
    tree = ast.parse((ROOT / package / "parallel" / "__init__.py")
                     .read_text())
    return sorted(alias.name for node in tree.body
                  if isinstance(node, ast.ImportFrom)
                  for alias in node.names)


def test_exported_names_match_the_jax_package():
    assert imported_names("smfft_tpu_torch") == imported_names("smfft_tpu")
    assert len(imported_names("smfft_tpu")) == 9
    assert all(hasattr(TP, name) for name in imported_names("smfft_tpu"))


def signatures(path):
    """{public function: [(kind, name, default source)]} of a module."""
    tree = ast.parse(path.read_text())
    sigs = {}
    for node in tree.body:
        if isinstance(node, ast.FunctionDef) and not node.name.startswith(
                "_"):
            a = node.args
            pos = a.posonlyargs + a.args
            pos_defaults = [None] * (len(pos) - len(a.defaults)) + [
                ast.unparse(v) for v in a.defaults]
            kw_defaults = [ast.unparse(v) if v is not None else None
                           for v in a.kw_defaults]
            sigs[node.name] = (
                [("pos", p.arg, v) for p, v in zip(pos, pos_defaults)]
                + [("kw", p.arg, v) for p, v in zip(a.kwonlyargs,
                                                    kw_defaults)])
    return sigs


@pytest.mark.parametrize("module", ["sharding", "distributed"])
def test_signatures_match_the_jax_package(module):
    """The public functions of sharding.py / distributed.py: the same
    names, and the same arguments, kinds and defaults, in order."""
    jax_sigs = signatures(ROOT / "smfft_tpu" / "parallel" / f"{module}.py")
    port_sigs = signatures(ROOT / "smfft_tpu_torch" / "parallel"
                           / f"{module}.py")
    assert port_sigs == jax_sigs


def test_port_imports_no_jax():
    """No module of the port, its example or chip_smoke.py imports jax or
    the JAX package."""
    paths = list((ROOT / "smfft_tpu_torch").rglob("*.py")) + [
        ROOT / "examples" / "matched_filter_torch.py",
        ROOT / "chip_smoke.py"]
    for path in paths:
        tree = ast.parse(path.read_text())
        for node in ast.walk(tree):
            mods = ([a.name for a in node.names]
                    if isinstance(node, ast.Import) else
                    [node.module or ""] if isinstance(node, ast.ImportFrom)
                    else [])
            for m in mods:
                assert not m.split(".")[0] in ("jax", "smfft_tpu"), path


def test_batch_mesh_needs_the_card_unless_told(tmp_path, monkeypatch):
    """No silent CPU mesh: without a process group batch_mesh raises;
    without a card the default ("cuda") raises and "cpu" must be asked
    for; a spawned "cuda" world without a card raises before it starts."""
    import torch.distributed as dist
    with pytest.raises(RuntimeError, match="process group"):
        TP.batch_mesh("cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="needs a CUDA device"):
        spawn_world(2, run_calls, ([],), workdir=str(tmp_path),
                    device="cuda")
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/rdv",
                            world_size=1, rank=0)
    try:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            TP.batch_mesh()
        with pytest.raises(ValueError, match="devices must be"):
            TP.batch_mesh("tpu")
        mesh = TP.batch_mesh("cpu")
        assert mesh.device_type == "cpu" and mesh.size() == 1
        assert mesh.mesh_dim_names == ("batch",)
        y = TP.sharded_fft(torch.zeros(4, 256, dtype=torch.complex64), mesh)
        assert y.to_local().device.type == "cpu"
    finally:
        dist.destroy_process_group()
