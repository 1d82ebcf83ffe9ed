"""The paper's Table 3: quicksort pivot strategies, serial and parallel.

On a mesh the paper's pivot strategies become the sample sort's splitter
strategies.  Two measurements:

  * serial sorts through ``ops.sort`` at the paper's element counts and at
    10^5 and 10^6 (the bitonic sort kernel on the card, its plain version
    on the CPU), beside the engine's serial and 8-chip predictions;
  * the sample sort on an 8-position mesh (eight shards of the card, or a
    CPU mesh), each pivot strategy's bucket imbalance: the quantity that
    makes random, left and right pivots slow (the paper's observation).
    The port's mesh is single-controller, so no subprocess is needed.
"""

from __future__ import annotations

import torch

from repro_torch.benches.common import mean_us, out_dir, session
from repro_torch.core.sort import PIVOT_STRATEGIES, distributed_sort
from repro_torch.kernels import ops

PAPER_NS = (1000, 1100, 1500, 2000)  # the paper's Table 3 element counts
BIG_NS = (100_000, 1_000_000)
MESH_POSITIONS = 8
# timed calls a size: the CPU's plain version of the network runs its 210
# stages at 2^20 one by one, seconds a call
REPS = {"cuda": 5, "cpu": 1}


def normal(n: int, seed: int, device) -> torch.Tensor:
    gen = torch.Generator(device="cpu").manual_seed(seed)
    return torch.randn((n,), generator=gen).to(device)


def make_sort_mesh(device: torch.device):
    """Eight positions of the sort's ``data`` axis on the session's one
    device."""
    from repro_torch.distributed import make_mesh

    return make_mesh({"data": MESH_POSITIONS}, device=device.type,
                     shards_per_device=MESH_POSITIONS)


def imbalance(xs: dict, mesh, engine=None,
              pivots=PIVOT_STRATEGIES) -> dict:
    """n -> {pivot: bucket imbalance} of the sample sort of ``xs[n]`` over
    the mesh's ``data`` axis (forced parallel, the local sorts on the
    sort kernel); every result must equal ``torch.sort``'s."""
    out = {}
    for n, x in xs.items():
        want = torch.sort(x).values
        per = {}
        for pivot in pivots:
            res, rep = distributed_sort(x, mesh, "data", pivot=pivot,
                                        force_parallel=True, engine=engine,
                                        local_sort="kernel")
            if not torch.equal(res, want):
                raise AssertionError(
                    f"sample sort with pivot {pivot!r} at n={n} differs "
                    f"from torch.sort")
            per[pivot] = rep.imbalance
        out[n] = per
    return out


def run(csv=True, runtime=None, out=None):
    rt = session(runtime)
    out_dir(out)
    dev = rt.device
    om = rt.engine.model  # the session's analytic model (the H100 default)
    rows = []
    for n in PAPER_NS + BIG_NS:
        x = normal(n, 0, dev)
        serial_us = mean_us(lambda: ops.sort(x), dev, reps=REPS[dev.type])
        pred_par = om.sort_cost(n, chips=8, strategy="parallel").total * 1e6
        pred_ser = om.sort_cost(n, strategy="serial").total * 1e6
        rows.append({"n": n, "serial_measured_us": serial_us,
                     "pred_serial_us": pred_ser, "pred_parallel8_us": pred_par})
        if csv:
            print(f"sort_serial,n={n},measured={serial_us:.1f}us,"
                  f"pred_serial={pred_ser:.2f}us,pred_par8={pred_par:.2f}us")
    data = imbalance({n: normal(n, 1, dev) for n in PAPER_NS},
                     make_sort_mesh(dev), engine=rt.engine)
    for n, per in data.items():
        if csv:
            print(f"sort_pivot_imbalance,n={n}," +
                  ",".join(f"{k}={v:.2f}" for k, v in per.items()))
    rows.append({"imbalance": data})
    return rows


if __name__ == "__main__":
    run()
