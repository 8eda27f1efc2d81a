"""TF32 emulated on float64 values: the float32 value rounded to nearest
with a 10-bit mantissa, as a tensor core rounds each operand of a product
(accumulation stays wide).  The references use it to read the controls:
themselves, put in the program's place, one precision below the
configurations' float32 with TF32 off."""

import numpy as np
import torch


def tf32(t: torch.Tensor) -> torch.Tensor:
    i = t.float().view(torch.int32)
    return ((i + 0x1000) & ~0x1FFF).view(torch.float32).to(t.dtype)


def tf32_np(a: np.ndarray) -> np.ndarray:
    i = np.asarray(a, dtype=np.float32).view(np.int32)
    return ((i + 0x1000) & ~0x1FFF).view(np.float32).astype(np.float64)
