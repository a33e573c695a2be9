"""Seeded weights, made on the device in one draw.

Both sides take their weights from here: the program's model is filled in
place, and the reference makes the same values again after the run. The
values depend only on the seed and on the parameter names and shapes
(`reference.model.param_shapes`), taken in that order:

  matrices and conv kernels  uniform(-a, a), a = sqrt(6 / (fan_in + fan_out))
                             (xavier; an LSTM kernel (in, 4H) counts
                             fan_in = in, fan_out = 4H)
  LSTM biases                0, the forget gate's block [H, 2H) at 1
  other biases               0
  norm scales                1
  running mean / variance    0 / 1
"""

from __future__ import annotations

import math
from typing import Dict, Mapping, Tuple

import torch


def _limit(name: str, shape: Tuple[int, ...]) -> float:
    if len(shape) == 3:                       # conv (out, in, k)
        out_c, in_c, k = shape
        return math.sqrt(6.0 / (in_c * k + out_c * k))
    if ".lstm.w_" in name:                    # (in, 4H)
        return math.sqrt(6.0 / (shape[0] + shape[1]))
    out_f, in_f = shape                       # dense (out, in)
    return math.sqrt(6.0 / (in_f + out_f))


@torch.no_grad()
def fill(tensors: Mapping[str, torch.Tensor],
         shapes: Mapping[str, Tuple[int, ...]], seed: int) -> None:
    """Write the seeded values of every name in `shapes` into `tensors`
    (name -> tensor of that shape, any dtype, all on one device)."""
    device = next(iter(tensors.values())).device
    drawn = [n for n, s in shapes.items() if len(s) >= 2]
    total = sum(math.prod(shapes[n]) for n in drawn)
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed))
    flat = torch.rand(total, generator=gen, device=device, dtype=torch.float32)
    off = 0
    for n in drawn:
        size = math.prod(shapes[n])
        a = _limit(n, shapes[n])
        view = flat[off:off + size].view(shapes[n])
        tensors[n].copy_(view.mul_(2 * a).sub_(a))
        off += size
    vectors = [n for n, s in shapes.items() if len(s) == 1]
    ones = [n for n in vectors
            if n.endswith(".weight") or n.endswith(".running_var")]
    torch._foreach_zero_([tensors[n] for n in vectors])
    if ones:
        torch._foreach_add_([tensors[n] for n in ones], 1.0)
    for n, s in shapes.items():
        if ".lstm.bias_" in n:
            H = s[0] // 4
            tensors[n][H:2 * H] = 1.0


def make(shapes: Mapping[str, Tuple[int, ...]], seed: int, device,
         dtype=torch.float32) -> Dict[str, torch.Tensor]:
    """New tensors holding the seeded values."""
    out = {n: torch.empty(s, device=device, dtype=dtype)
           for n, s in shapes.items()}
    fill(out, shapes, seed)
    return out
