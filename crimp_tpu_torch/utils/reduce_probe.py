"""Does a row's sum depend on the rows reduced beside it?

    python -m crimp_tpu_torch.utils.reduce_probe [cuda|cpu]

For f32 and f64 rows of 300, 1 200, 20 000 and 40 000 seeded uniforms, it
reduces a (128, 64, n) block over its last axis, then sub-blocks of 1, 4 and
16 rows (x 1 and 64 columns), and counts the sub-block results whose bits
differ from the whole block's: with ``torch.sum`` and with ``tree_sum``, a
sum in a fixed order. It also counts such differences for batched matrix
products (batch 1, 4, 16 against 128) at inner sizes 6 and 12. Prints one
JSON object of counts (0 = the row's bits do not depend on its neighbours).

``tree_sum`` is the candidate the port measured and did not adopt:
``chip_smoke.py`` phase 8 swaps it in for ``ops/reduce.event_sum`` to time
what it costs the survey.
"""

from __future__ import annotations

import json
import sys

import torch
import torch.nn.functional as F

BLOCK = 32


def tree_sum(x: torch.Tensor) -> torch.Tensor:
    """Sum over the last axis in a fixed 32-ary tree of zero-padded blocks
    (padding adds exactly +0.0), so a row's bits do not depend on the rows
    beside it -> x.shape[:-1]."""
    if x.shape[-1] == 0:
        return torch.sum(x, dim=-1)
    while x.shape[-1] > 1:
        pad = (-x.shape[-1]) % BLOCK
        if pad:
            x = F.pad(x, (0, pad))
        x = torch.sum(x.reshape(*x.shape[:-1], -1, BLOCK), dim=-1)
    return x[..., 0]


def probe(device: str = "cuda") -> dict:
    gen = torch.Generator().manual_seed(0)
    out = {}
    for dtype in (torch.float32, torch.float64):
        for n in (300, 1200, 20000, 40000):
            big = torch.rand(128, 64, n, generator=gen, dtype=torch.float64).to(dtype).to(device)
            for name, fn in (("sum", lambda x: x.sum(-1)), ("tree_sum", tree_sum)):
                whole = fn(big)
                out[f"{name}_{str(dtype)[6:]}_{n}"] = sum(
                    int((fn(big[:rows, :cols].contiguous()) != whole[:rows, :cols]).sum())
                    for rows in (1, 4, 16) for cols in (1, 64))
    for k in (6, 12):
        a = torch.rand(128, 64, k, generator=gen, dtype=torch.float64).to(device)
        b = torch.rand(128, k, 300, generator=gen, dtype=torch.float64).to(device)
        whole = a @ b
        out[f"bmm_k{k}"] = sum(int(((a[:r] @ b[:r]) != whole[:r]).sum()) for r in (1, 4, 16))
    return out


if __name__ == "__main__":
    torch.set_num_threads(2)
    print(json.dumps(probe(sys.argv[1] if len(sys.argv) > 1 else "cuda")))
