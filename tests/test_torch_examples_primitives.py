"""``examples/microbench_primitives_torch.py`` against the JAX script's
cases: one round (i = 0, dep = 0) of each of the 27 cases on the same
numpy inputs at a small size (N = 4,000, M = 1,000, NQ = 3,000, NA =
19,000, NS = 4,800; the ``sort*`` keys with forced ties where the JAX
script forces them), the JAX expression copied from
``examples/microbench_primitives.py``. Sorts, gathers, scatters, top-k and
searchsorted identical; ``cumsum`` and the segment sums within rtol 1e-6
(another summation order); the elementwise case within 1e-6 (XLA's and
torch's ``sin``/``tanh``); ``uniform120k`` draws by design from another
generator, so only its shape and range are held. Then ``main`` runs every
case at that size.
"""

import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_parity  # noqa: F401  (shares the cores among workers)

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "examples"))

import microbench_primitives_torch as mb  # noqa: E402

SIZES = {"n": 4000, "m": 1000, "nq": 3000, "na": 19000, "ns": 4800}
CLOSE = {"cumsum120k", "scatteradd120k_c1", "segsum120k_c2",
         "elementwise120k"}


def base_inputs() -> dict:
    rng = np.random.default_rng(7)
    N, M = SIZES["n"], SIZES["m"]
    return {"x": rng.standard_normal((N, 4)).astype(np.float32),
            "pr": rng.random(N).astype(np.float32),
            "perm": rng.permutation(N).astype(np.int32),
            "h": rng.integers(0, 1 << 30, N).astype(np.int32),
            "seg": np.sort(rng.integers(0, M, N)).astype(np.int32)}


def jax_cases(b: dict) -> dict:
    """The JAX script's cases, copied, on ``b`` at ``SIZES``."""
    N, M, NQ = SIZES["n"], SIZES["m"], SIZES["nq"]
    x, pr, perm, h, seg = (jnp.asarray(b[k]) for k in
                           ("x", "pr", "perm", "h", "seg"))
    key = jax.random.PRNGKey(0)
    hs_sorted = jnp.sort(h[:NQ])
    iq = jnp.arange(N, dtype=jnp.int32)

    def idep(i, dep):
        return jnp.int32(i) + jnp.int32(dep)

    C = {}
    C["sort120k_k1_p1"] = lambda i, dep: jax.lax.sort(
        (pr + dep + i, iq), num_keys=1)[1].astype(jnp.float32)
    C["sort120k_k1_p4"] = lambda i, dep: sum(
        o for o in jax.lax.sort(
            (pr + dep + i, pr * 2, pr * 3, pr * 4, pr * 5), num_keys=1)[1:])
    C["sort120k_i32_k1_p1"] = lambda i, dep: jax.lax.sort(
        (h + idep(i, dep), iq), num_keys=1)[1].astype(jnp.float32)
    C["sort30k_k1_p1"] = lambda i, dep: jax.lax.sort(
        (pr[:M] + dep + i, iq[:M]), num_keys=1)[1].astype(jnp.float32)
    C["sort30k_k2_p1"] = lambda i, dep: jax.lax.sort(
        (h[:M] + idep(i, dep), pr[:M], iq[:M]), num_keys=2)[2].astype(
            jnp.float32)
    C["sort90k_k1_p4"] = lambda i, dep: sum(
        o for o in jax.lax.sort(
            (pr[:NQ] + dep + i, pr[:NQ] * 2, pr[:NQ] * 3, pr[:NQ] * 4,
             pr[:NQ] * 5), num_keys=1)[1:])
    C["scatter120k_c4"] = lambda i, dep: jnp.zeros(
        (N, 4), jnp.float32).at[perm].set(x + dep + i, mode="drop")
    C["scatter120k_c3"] = lambda i, dep: jnp.zeros(
        (N, 3), jnp.float32).at[perm].set(x[:, :3] + dep + i, mode="drop")
    C["scatter120k_c1"] = lambda i, dep: jnp.zeros(
        (N,), jnp.float32).at[perm].set(pr + dep + i, mode="drop")
    C["scatteradd120k_c1"] = lambda i, dep: jnp.zeros(
        (N,), jnp.float32).at[seg].add(pr + dep + i, mode="drop")
    C["gather120k_c3"] = lambda i, dep: (x[:, :3] + dep + i)[perm]
    C["gather120k_c1"] = lambda i, dep: (pr + dep + i)[perm]
    C["gather30k_from120k_c3"] = lambda i, dep: (
        x[:, :3] + dep + i)[perm[:M]]
    C["cumsum120k"] = lambda i, dep: jnp.cumsum(pr + dep + i)
    C["segsum120k_c2"] = lambda i, dep: jax.ops.segment_sum(
        jnp.stack([pr + dep + i, pr * 2], axis=1), seg, num_segments=N)
    C["concat_2x120k_c3"] = lambda i, dep: jnp.concatenate(
        [x[:, :3] + dep + i, x[:, :3] * 2], axis=0)
    C["elementwise120k"] = lambda i, dep: jnp.tanh(
        (x + dep + i) * 0.5 + jnp.sin(x) * (x - 0.1) + x * x)
    C["searchsorted_256_in90k"] = lambda i, dep: jnp.searchsorted(
        hs_sorted + idep(i, dep),
        jnp.arange(256, dtype=jnp.int32)).astype(jnp.float32)
    C["uniform120k"] = lambda i, dep: jax.random.uniform(
        jax.random.fold_in(key, idep(i, dep)), (N,))
    C["topk120k_30k"] = lambda i, dep: jax.lax.top_k(pr + dep + i, M)[0]
    C["sort120k_i32_k1_p5"] = lambda i, dep: sum(
        o for o in jax.lax.sort(
            (h + idep(i, dep), pr, pr * 2, pr * 3, pr * 4, pr * 5),
            num_keys=1)[1:])
    h2 = jnp.concatenate([h, h[::-1]])
    pr2 = jnp.concatenate([pr, pr[::-1]])
    C["sort240k_i32_k1_p5"] = lambda i, dep: sum(
        o for o in jax.lax.sort(
            (h2 + idep(i, dep), pr2, pr2 * 2, pr2 * 3, pr2 * 4, pr2 * 5),
            num_keys=1)[1:])
    h4 = jnp.concatenate([h2, h2[::-1]])
    pr4 = jnp.concatenate([pr2, pr2[::-1]])
    C["sort480k_i32_k1_p5"] = lambda i, dep: sum(
        o for o in jax.lax.sort(
            (h4 + idep(i, dep), pr4, pr4 * 2, pr4 * 3, pr4 * 4, pr4 * 5),
            num_keys=1)[1:])
    qg = jnp.mod(perm[:8192], M)
    C["gather8k_from30k_c3"] = lambda i, dep: (x[:M, :3] + dep + i)[qg]
    NA = SIZES["na"]
    ha = jnp.concatenate([h, h[::-1], h, h[::-1], h])[:NA]
    ia = jnp.arange(NA, dtype=jnp.int32)
    xa = jnp.concatenate([x[:, :3]] * 5, axis=0)[:NA]
    C["sort578k_i32_k1_p1"] = lambda i, dep: jax.lax.sort(
        (ha + idep(i, dep), ia), num_keys=1)[1].astype(jnp.float32)
    pa = jnp.mod(jnp.cumsum(ha.astype(jnp.int64) % 1000003).astype(
        jnp.int32), NA)
    C["gather578k_c3"] = lambda i, dep: (xa + dep + i)[pa]
    NS = SIZES["ns"]
    C["sort145k_i32_k1_p1"] = lambda i, dep: jax.lax.sort(
        (ha[:NS] + idep(i, dep), ia[:NS]),
        num_keys=1)[1].astype(jnp.float32)
    return C


@pytest.fixture(scope="module")
def both():
    b = base_inputs()
    port = mb.cases(mb.derive({k: torch.from_numpy(v) for k, v in b.items()},
                              SIZES), SIZES)
    return port, jax_cases(b)


def test_the_jax_scripts_27_cases_by_name(both):
    port, jax_c = both
    assert list(port) == list(jax_c) and len(port) == 27


@pytest.mark.parametrize("name", [n for n in jax_cases(base_inputs())
                                  if n != "uniform120k"])
def test_one_round_equals_the_jax_case(both, name):
    port, jax_c = both
    got = port[name](0, torch.zeros(())).numpy()
    want = np.asarray(jax_c[name](0, jnp.float32(0.0)))
    assert got.shape == want.shape and got.dtype == want.dtype
    if name == "elementwise120k":
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    elif name in CLOSE:
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    else:
        np.testing.assert_array_equal(got, want)


def test_uniform_shape_and_range(both):
    port, _ = both
    torch.manual_seed(0)
    u = port["uniform120k"](0, torch.zeros(()))
    assert u.shape == (SIZES["n"],) and u.dtype == torch.float32
    assert float(u.min()) >= 0.0 and float(u.max()) < 1.0


def test_main_runs_every_case(monkeypatch):
    monkeypatch.setattr(mb, "CHAIN", 2)
    res = mb.main([*(f"--{k}={v}" for k, v in SIZES.items()), "--reps", "1",
                   "--device", "cpu"])
    assert len(res["cases"]) == 27 and res["chain"] == 2
    base = res["cases"][mb.BASELINE]["ms"]
    for r in res["cases"].values():
        assert np.isfinite(r["ms"]) and r["ms"] > 0
        assert r["net_ms"] == pytest.approx(r["ms"] - base)


def test_main_picks_cases_and_refuses_unknown():
    res = mb.main(["gather120k_c1", "--n", "400", "--m", "100", "--nq", "300",
                   "--na", "1900", "--ns", "480", "--reps", "1", "--device",
                   "cpu"])
    assert list(res["cases"]) == ["gather120k_c1"]
    with pytest.raises(ValueError, match="unknown cases"):
        mb.main(["sort1m", "--n", "400", "--m", "100", "--nq", "300",
                 "--na", "1900", "--ns", "480", "--device", "cpu"])
