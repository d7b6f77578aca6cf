"""Arithmetic precision of the reference's float products.

``F32`` multiplies in float32, as the configurations state.  ``TF32``
rounds both factors of every product to TF32 (10 mantissa bits, round to
nearest even) and multiplies in float32, as a TF32 matrix unit does: the
benchmark's control, the step below float32 that a faster transform
(a TF32 ``matmul`` in place of the explicit multiply-adds) would take.
"""

from __future__ import annotations

import torch


def to_tf32(x):
    """Round a float32 tensor (or a Python float) to TF32."""
    if not torch.is_tensor(x):
        x = torch.tensor(x, dtype=torch.float32)
    bits = x.to(torch.float32).contiguous().view(torch.int32)
    lsb = (bits >> 13) & 1
    rounded = (bits + 0x0FFF + lsb) & ~0x1FFF
    return rounded.view(torch.float32)


class F32:
    name = "f32"

    @staticmethod
    def mul(a, b):
        return a * b


class TF32:
    name = "tf32"

    @staticmethod
    def mul(a, b):
        tb = to_tf32(b)
        if torch.is_tensor(a):
            tb = tb.to(a.device)
        return to_tf32(a).to(tb.device) * tb


PRECISIONS = {"f32": F32, "tf32": TF32}
