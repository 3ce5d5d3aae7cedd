"""K1's per-pixel form (cybervision_tpu_torch/csrc/ncc_sweep.cu,
sweep_pixel_tile_kernel) at several shared-memory budgets per block,
which set the plan's chunk of offsets and so how many blocks share an
SM; and its time against the number of stripes, which splits it into a
cost per tile (staging img1, the two votes) and a cost per stripe.

Two fields, each checked bit for bit against the plain version first:
- chip_smoke.py phase 2's per-pixel case: the 1024x1024 SEM pair's
  finest fields (window 16, 5 stripes) with the axis on a checkerboard
  of 64-pixel squares;
- a 1024x820 pair's finest fields at the diagonal run's window and
  stripes (32, 9) with the axis flipping across the image's diagonal
  (the SEM pair's content, not phase 6's rendered scene).
Times are CUDA events around 5 calls after a warm-up, the budgets in
turns (forward, then backward), on one card. It prints the card's name
and power limit first.

Usage, from the repo root, on a machine with a CUDA card (~1 minute):
    python tools/k1_pixel_budget.py
"""

import os
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke as cs  # noqa: E402
from cybervision_tpu_torch.config import CorrelationConfig, ProjectionMode  # noqa: E402
from cybervision_tpu_torch.ops import correlation as corr  # noqa: E402
from cybervision_tpu_torch.ops import ncc_sweep as k1  # noqa: E402

# One block per SM at the whole window; two (228 KB, less 1 KB a block);
# three.
BUDGETS = (k1.SMEM_LIMIT, 115_712, 76_800)


def diagonal_case(dev, h=820, w=1024, window=32, corridor_size=4):
    cc = CorrelationConfig()
    aff = ProjectionMode.AFFINE
    a, b, d = cs.synth_sem_pair(h, w)
    f = np.array([[0, 0, 0], [0, 0, 1], [0, -1, 0]], np.float64)
    wtr, tmin = corr.split_trange(corr.warp_shift_range(f, 1.0, h, w, h, w))
    fields = corr.sweep_inputs(
        torch.as_tensor(a, device=dev), torch.as_tensor(b, device=dev),
        cs._finest_prev_state(d, dev), torch.as_tensor(f, dtype=torch.float32, device=dev),
        1.0, cc.min_stdev(aff), cc.corridor_min_range(aff), cc.corridor_extend_range(aff),
        corridor_size, wtr, tmin, "horiz",
    )
    kw = dict(threshold=cc.threshold(aff), min_stdev=cc.min_stdev(aff), window=window,
              corridor_size=corridor_size, h2=h, w2=w)
    return cs.mixed_axes(fields, "diagonal"), kw


def use_budget(limit: int) -> None:
    # sweep_tile_plan reads the budget on every call.
    k1.PIXEL_SMEM_LIMIT = limit


def main() -> int:
    if not torch.cuda.is_available():
        print("k1_pixel_budget: no CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    print(cs.nvidia_smi_line())
    default = k1.PIXEL_SMEM_LIMIT
    fields, kw = cs.sweep_case(dev, "horiz", 1024, 1024)
    cases = {
        "1024x1024 checkerboard, window 16, 5 stripes": (cs.mixed_axes(fields, "checker"), kw),
        "1024x820 diagonal, window 32, 9 stripes": diagonal_case(dev),
    }
    for name, (f, kw) in cases.items():
        args = list(f.values())
        ref = k1.ncc_sweep_plain(*args, axis=None, **kw)
        times = {b: [] for b in BUDGETS}
        for order in (BUDGETS, BUDGETS[::-1]):
            for b in order:
                use_budget(b)
                out = k1.ncc_sweep(*args, axis=None, **kw)
                if not all(torch.equal(x, y) for x, y in zip(out, ref)):
                    raise AssertionError(f"{name}, budget {b}: not bit-equal to the plain version")
                times[b].append(cs.cuda_ms(lambda: k1.ncc_sweep(*args, axis=None, **kw), 5))
        for b in BUDGETS:
            use_budget(b)
            plan = k1.sweep_tile_plan(*f["avg1"].shape, kw["window"], None)
            print(f"{name}: budget {b} B -> chunk {plan['chunk']}, {plan['smem_bytes']} B a"
                  f" block; ms {[round(t, 4) for t in times[b]]}")
        use_budget(default)
        n_o = f["w0"].shape[0]
        for n in sorted({1, 3, n_o}):
            c = (n - 1) // 2
            mid = kw["corridor_size"]
            g = dict(f, w0=f["w0"][mid - c: mid + c + 1].contiguous())
            kw_n = dict(kw, corridor_size=c)
            ms = cs.cuda_ms(lambda: k1.ncc_sweep(*g.values(), axis=None, **kw_n), 5)
            print(f"{name}: {n} stripes at budget {default} B: {ms:.4f} ms")
    return 0


if __name__ == "__main__":
    sys.exit(main())
