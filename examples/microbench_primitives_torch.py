"""The data-movement primitives of the sampler's step (sorts, scatters,
gathers, segment sums, top-k, searchsorted) timed alone at production
sizes on the PyTorch port: the counterpart of
``examples/microbench_primitives.py``, with its 27 cases by name.

Each case is chained ``PCST_MB_CHAIN`` times (50) in one body, each round
fed a scalar from the one before (the full sum of its result x 1e-20), so
the rounds run in order and none is skipped; on the card the body is one
CUDA graph (``models/capture.py``) replayed ``--reps`` times (3) between
CUDA events, and a case's time is ms a round (the median replay / the
chain), printed beside its time net of ``elementwise120k`` (the same
round's sum and a bandwidth pass of [120k, 4] elementwise work: the
baseline every case carries). The JAX script's forced host transfer
worked round a host relay the card does not have.

The JAX primitives and the port's:
  ``lax.sort(num_keys=1)`` + payloads  ``torch.sort(stable=True)``, the
                                       payloads gathered by its indices;
  ``num_keys=2``                       ``grid_knn._stable_argsort_2key``;
  ``.at[].set(mode="drop")``           ``index_copy_``;
  ``.at[seg].add``, ``segment_sum``    ``index_add_``;
  ``searchsorted``, ``cumsum``,        ``torch.searchsorted``,
  ``top_k``                            ``torch.cumsum``, ``torch.topk``;
  ``random.uniform(fold_in(...))``     ``torch.rand`` (the default
                                       generator, seeded; a captured
                                       graph advances it each replay).

Usage: python examples/microbench_primitives_torch.py [case ...]
           [--reps 3] [--n 120000] [--m 30000] [--nq 90112] [--na 578368]
           [--ns 145000] [--device cuda|cpu]
``--na`` is the B = 4 assembly's rows (B*M + the padded layout's), ``--ns``
the 145,000-row slice of them; ``--na`` is at most 5 x ``--n``.
"""

from __future__ import annotations

import argparse
import os
import sys
from typing import Callable

import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import profile_common_torch as common  # noqa: E402
from pointcloud_style_transfer_torch.device import resolve_device  # noqa: E402
from pointcloud_style_transfer_torch.ops.grid_knn import \
    _stable_argsort_2key  # noqa: E402

CHAIN = int(os.environ.get("PCST_MB_CHAIN", "50"))
SIZES = {"n": 120_000, "m": 30_000, "nq": 90_112, "na": 578_368,
         "ns": 145_000}
BASELINE = "elementwise120k"


def draw_base(gen: torch.Generator, sizes: dict,
              dev: torch.device) -> dict:
    """The drawn inputs: x [N, 4] normal, pr [N] uniform, perm [N] a
    permutation, h [N] int32 in [0, 2^30), seg [N] sorted int32 in [0, M)."""
    N, M = sizes["n"], sizes["m"]
    return {"x": torch.randn((N, 4), generator=gen, device=dev),
            "pr": torch.rand((N,), generator=gen, device=dev),
            "perm": torch.randperm(N, generator=gen, device=dev),
            "h": torch.randint(0, 1 << 30, (N,), generator=gen, device=dev,
                               dtype=torch.int32),
            "seg": torch.sort(torch.randint(0, M, (N,), generator=gen,
                                            device=dev,
                                            dtype=torch.int32)).values}


def derive(base: dict, sizes: dict) -> dict:
    """Everything the cases read, from ``draw_base``'s arrays (the JAX
    script's derived arrays, built the same way)."""
    N, M, NQ, NA = sizes["n"], sizes["m"], sizes["nq"], sizes["na"]
    x, pr, h = base["x"], base["pr"].float(), base["h"].int()
    perm, seg = base["perm"].long(), base["seg"].long()
    dev = x.device
    flip = lambda t: t.flip(0)  # noqa: E731
    h2, pr2 = torch.cat([h, flip(h)]), torch.cat([pr, flip(pr)])
    h4, pr4 = torch.cat([h2, flip(h2)]), torch.cat([pr2, flip(pr2)])
    ha = torch.cat([h, flip(h), h, flip(h), h])[:NA]
    # the JAX script's int32 cumsum wraps round 2^32; so does this one
    c = torch.cumsum(ha.long() % 1000003, 0)
    wrapped = ((c + 2 ** 31) % 2 ** 32 - 2 ** 31).int()
    return {
        "x": x, "x3": x[:, :3].contiguous(), "pr": pr, "h": h,
        "perm": perm, "seg": seg,
        "iq": torch.arange(N, dtype=torch.int32, device=dev),
        "hs_sorted": torch.sort(h[:NQ]).values,
        "q256": torch.arange(256, dtype=torch.int32, device=dev),
        "pays": [pr * j for j in (1, 2, 3, 4, 5)],
        "h2": h2, "pays2": [pr2 * j for j in (1, 2, 3, 4, 5)],
        "h4": h4, "pays4": [pr4 * j for j in (1, 2, 3, 4, 5)],
        "qg": torch.remainder(perm[:8192], M),
        "ha": ha, "ia": torch.arange(NA, dtype=torch.int32, device=dev),
        "xa": torch.cat([x[:, :3]] * 5)[:NA].contiguous(),
        "pa": torch.remainder(wrapped, NA).long()}


def sorted_payloads(key: torch.Tensor, payloads) -> list:
    """The payloads in the order of a stable sort of ``key``."""
    o = torch.sort(key, stable=True).indices
    return [p[o] for p in payloads]


def cases(d: dict, sizes: dict) -> dict:
    """Each case's round ``fn(i, dep)`` (i the round, dep the 0-d float
    from the round before) by the JAX script's name."""
    N, M, NQ, NS = sizes["n"], sizes["m"], sizes["nq"], sizes["ns"]
    x, x3, pr, h, iq = d["x"], d["x3"], d["pr"], d["h"], d["iq"]
    perm, seg = d["perm"], d["seg"]

    def idep(i, dep):  # the int32 round offset carrying the dependency
        return dep.int() + i

    def payload_sum(key, pays):
        return sum(sorted_payloads(key, pays))

    C: dict[str, Callable] = {}
    C["sort120k_k1_p1"] = lambda i, dep: sorted_payloads(
        pr + dep + i, [iq])[0].float()
    C["sort120k_k1_p4"] = lambda i, dep: payload_sum(pr + dep + i,
                                                     d["pays"][1:])
    C["sort120k_i32_k1_p1"] = lambda i, dep: sorted_payloads(
        h + idep(i, dep), [iq])[0].float()
    C["sort30k_k1_p1"] = lambda i, dep: sorted_payloads(
        pr[:M] + dep + i, [iq[:M]])[0].float()
    C["sort30k_k2_p1"] = lambda i, dep: iq[:M][_stable_argsort_2key(
        h[:M] + idep(i, dep), pr[:M])].float()
    C["sort90k_k1_p4"] = lambda i, dep: payload_sum(
        pr[:NQ] + dep + i, [p[:NQ] for p in d["pays"][1:]])
    C["scatter120k_c4"] = lambda i, dep: torch.zeros_like(x).index_copy_(
        0, perm, x + dep + i)
    C["scatter120k_c3"] = lambda i, dep: torch.zeros_like(x3).index_copy_(
        0, perm, x3 + dep + i)
    C["scatter120k_c1"] = lambda i, dep: torch.zeros_like(pr).index_copy_(
        0, perm, pr + dep + i)
    C["scatteradd120k_c1"] = lambda i, dep: torch.zeros_like(pr).index_add_(
        0, seg, pr + dep + i)
    C["gather120k_c3"] = lambda i, dep: (x3 + dep + i)[perm]
    C["gather120k_c1"] = lambda i, dep: (pr + dep + i)[perm]
    C["gather30k_from120k_c3"] = lambda i, dep: (x3 + dep + i)[perm[:M]]
    C["cumsum120k"] = lambda i, dep: torch.cumsum(pr + dep + i, 0)
    C["segsum120k_c2"] = lambda i, dep: pr.new_zeros((N, 2)).index_add_(
        0, seg, torch.stack([pr + dep + i, pr * 2], dim=1))
    C["concat_2x120k_c3"] = lambda i, dep: torch.cat([x3 + dep + i, x3 * 2])
    C["elementwise120k"] = lambda i, dep: torch.tanh(
        (x + dep + i) * 0.5 + torch.sin(x) * (x - 0.1) + x * x)
    C["searchsorted_256_in90k"] = lambda i, dep: torch.searchsorted(
        d["hs_sorted"] + idep(i, dep), d["q256"]).float()
    C["uniform120k"] = lambda i, dep: torch.rand(
        (N,), device=pr.device) + dep
    C["topk120k_30k"] = lambda i, dep: torch.topk(pr + dep + i, M).values
    C["sort120k_i32_k1_p5"] = lambda i, dep: payload_sum(
        h + idep(i, dep), d["pays"])
    C["sort240k_i32_k1_p5"] = lambda i, dep: payload_sum(
        d["h2"] + idep(i, dep), d["pays2"])
    C["sort480k_i32_k1_p5"] = lambda i, dep: payload_sum(
        d["h4"] + idep(i, dep), d["pays4"])
    C["gather8k_from30k_c3"] = lambda i, dep: (x3[:M] + dep + i)[d["qg"]]
    C["sort578k_i32_k1_p1"] = lambda i, dep: sorted_payloads(
        d["ha"] + idep(i, dep), [d["ia"]])[0].float()
    C["gather578k_c3"] = lambda i, dep: (d["xa"] + dep + i)[d["pa"]]
    C["sort145k_i32_k1_p1"] = lambda i, dep: sorted_payloads(
        d["ha"][:NS] + idep(i, dep), [d["ia"][:NS]])[0].float()
    return C


def chained(fn: Callable, chain: int):
    """The body: ``chain`` rounds of ``fn``, each fed the full sum of the
    round before x 1e-20."""
    def body(ins):
        dep = ins["dep"]
        for i in range(chain):
            dep = fn(i, dep).sum().float() * 1e-20
        return dep
    return body


@torch.no_grad()
def main(argv=None) -> dict:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("cases", nargs="*", help="cases (all by default)")
    parser.add_argument("--reps", type=int, default=3)
    for name, value in SIZES.items():
        parser.add_argument(f"--{name}", type=int, default=value)
    common.script_args(parser, config=False)
    args = parser.parse_args(argv)
    sizes = {name: getattr(args, name) for name in SIZES}
    if not sizes["ns"] <= sizes["na"] <= 5 * sizes["n"]:
        raise ValueError(f"need ns <= na <= 5 n, got {sizes}")
    dev = resolve_device(args.device)
    card = common.device_name(dev)
    gen = torch.Generator(device=dev).manual_seed(common.SEED)
    C = cases(derive(draw_base(gen, sizes, dev), sizes), sizes)
    want = args.cases or list(C)
    unknown = [c for c in want if c not in C]
    if unknown:
        raise ValueError(f"unknown cases {unknown}; known: {list(C)}")
    torch.manual_seed(common.SEED)  # uniform120k's generator
    print(f"device={card}  chain={CHAIN}  sizes={sizes}")
    owner = common.Owner()
    dep0 = torch.zeros((), device=dev)
    readings = {}
    for name in [BASELINE] + [c for c in want if c != BASELINE]:
        readings[name] = common.timed_body(
            ("microbench", name, CHAIN, repr(sizes)),
            chained(C[name], CHAIN), {"dep": dep0}, owner, args.reps, dev,
            per=CHAIN)
        readings[name].pop("first")
        net = readings[name]["ms"] - readings[BASELINE]["ms"]
        readings[name]["net_ms"] = net
        if name in want:
            print(f"{name:24s} {readings[name]['ms']:8.4f} ms a round "
                  f"({net:+.4f} net of {BASELINE}; spread "
                  f"{100 * readings[name]['spread']:.1f}%)", flush=True)
    common.capture.release()
    return {"device": card, "chain": CHAIN, "sizes": sizes,
            "cases": {n: readings[n] for n in want}}


if __name__ == "__main__":
    main()
