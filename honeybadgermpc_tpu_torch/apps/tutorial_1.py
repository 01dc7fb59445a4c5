"""Tutorial 1: basic MPC programs on the simulated n-party network
(reference apps/tutorial/hbmpc-tutorial-1.py): Beaver multiplication,
pairwise swap with a shared bit, and a secret dot product.

Counterpart of ``apps/tutorial_1.py`` on the port's runtime (``cuda``
unless the caller passes another device).

Run: python -m honeybadgermpc_tpu_torch.apps.tutorial_1 [--device cpu]
"""

import argparse
import random

import torch

from ..elliptic_curve import Subgroup
from ..models.butterfly import batch_switch
from ..ops.fparray import FpArray
from ..runtime.comparison import _sum_last
from ..runtime.context import MpcContext
from ..runtime.preprocessing import PreProcessedElements

P = Subgroup.BLS12_381


def main(device=torch.device("cuda")):
    n, t = 4, 1
    rng = random.Random(1)
    pre = PreProcessedElements(n, t, seed=0, device=device)
    pre.generate_triples(128)
    pre.generate_one_minus_ones(16)
    ctx = MpcContext(n, t, preproc=pre, device=device)

    def share(vals):
        return ctx.ShareArray(pre._share_values(
            FpArray.from_ints(vals, device=device)))

    # 1) Beaver multiplication
    xs = [rng.randrange(P) for _ in range(4)]
    ys = [rng.randrange(P) for _ in range(4)]
    prod = (share(xs) * share(ys)).open()
    assert list(prod.to_ints()[0]) == [x * y % P for x, y in zip(xs, ys)]
    print("beaver multiply: ok")

    # 2) secure pairwise swap (one butterfly switch)
    a, b = share([111]), share([222])
    sbit = ctx.from_preproc(pre.get_one_minus_ones(1))
    oa, ob = batch_switch(ctx, a, b, ctx.ShareArray(sbit.v))
    got = sorted([int(oa.open().to_ints()[0][0]),
                  int(ob.open().to_ints()[0][0])])
    assert got == [111, 222]
    print("secret switch: ok")

    # 3) dot product: sum(x_i * y_i) via one batched multiply + local sum
    dp = (share(xs) * share(ys))
    summed = _sum_last(dp.v)
    total = ctx.ShareArray(FpArray(summed.limbs[..., None]), dp.t).open()
    want = sum(x * y for x, y in zip(xs, ys)) % P
    assert int(total.to_ints()[0][0]) == want
    print("dot product: ok")


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description="Tutorial 1 on the port.")
    ap.add_argument("--device", default="cuda")
    main(torch.device(ap.parse_args().device))
