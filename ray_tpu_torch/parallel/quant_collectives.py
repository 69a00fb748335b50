"""Int8 block-scaled gradient collectives (the EQuARX scheme).

Counterpart of ``ray_tpu/parallel/quant_collectives.py``.  Where bandwidth
bounds the data-parallel step, the fp32 gradient all-reduce is the wire
cost; each reduce-scatter / all-gather payload goes as int8 with one fp32
scale per ``block`` elements instead (n + 4n/block bytes against 4n), and
every sum is taken in fp32 after dequantizing.

Quantization is symmetric per block: ``scale = amax / 127`` (1 for an
all-zero block, so it comes back exact), values rounded to nearest, ties
to even (``torch.round``, as ``jnp.round``), or stochastically
(``floor(y + u)``, u ~ U[0, 1): unbiased).  One round trip errs by at most
``scale / 2 = amax / 254`` per element and device (a full step, amax/127,
stochastically).

Two things differ from the reference, by the port's idiom:

* The collectives take the list of one dp group's per-device parts and
  return a list, as ``parallel/mesh.py``'s collectives do, where the
  reference's run inside a ``shard_map`` over an axis name.  Row i of
  every part (int8 payload and fp32 scales only) moves to part i's
  device, which dequantizes and sums them in rank order: the chunk
  placement of ``lax.psum_scatter(tiled=True)``, bitwise repeatable.
* Random numbers come from a ``torch.Generator`` (one per part in the
  collectives, on that part's device) in place of a PRNG key; stochastic
  rounding without one raises, as the reference raises without a key.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import torch

__all__ = [
    "DEFAULT_BLOCK", "quantize_int8_block", "dequantize_int8_block",
    "quantized_psum_scatter", "quantized_all_gather", "quant_error_bound",
]

#: Elements sharing one fp32 scale: 4/256 = 1.6% of the int8 payload.
DEFAULT_BLOCK = 256


def quantize_int8_block(x: torch.Tensor, block: int = DEFAULT_BLOCK,
                        stochastic: bool = False,
                        generator: Optional[torch.Generator] = None
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """[..., n] -> (int8 [..., n], fp32 scales [..., n/block]) on x's
    device.  ``stochastic`` rounds x/scale to floor(y + u) with u drawn
    from ``generator``."""
    *lead, n = x.shape
    if n % block:
        raise ValueError(f"block {block} does not divide the last "
                         f"dimension {n}")
    with torch.profiler.record_function("quantize_int8_block"):
        xb = x.float().reshape(*lead, n // block, block)
        amax = xb.abs().amax(dim=-1, keepdim=True)
        # divided by a tensor: PyTorch's CUDA division by a Python number
        # multiplies by its reciprocal, which rounds some scales one bit
        # off the reference's (and the host's) amax / 127
        scale = torch.where(amax > 0.0, amax / torch.full_like(amax, 127.0),
                            torch.ones_like(amax))
        y = xb / scale
        if stochastic:
            if generator is None:
                raise ValueError("stochastic rounding needs a "
                                 "torch.Generator")
            y.add_(torch.rand(y.shape, generator=generator,
                              dtype=torch.float32, device=y.device))
            y.floor_()
        else:
            y.round_()
        q = y.clamp_(-127.0, 127.0).to(torch.int8)
        return q.reshape(*lead, n), scale.squeeze(-1)


def dequantize_int8_block(q: torch.Tensor, scale: torch.Tensor,
                          block: int = DEFAULT_BLOCK) -> torch.Tensor:
    """Inverse of ``quantize_int8_block``: (int8 [..., n], scales) ->
    fp32."""
    *lead, n = q.shape
    with torch.profiler.record_function("dequantize_int8_block"):
        xb = q.float().reshape(*lead, n // block, block)
        return (xb * scale[..., None]).reshape(*lead, n)


def quant_error_bound(x_amax: float, block: int, world: int) -> float:
    """Worst-case absolute error of a quantized ``world``-way reduction of
    values whose per-block amax is <= x_amax: each device contributes at
    most scale/2 = amax/254 per element (deterministic rounding);
    stochastic rounding is bounded by a full step, amax/127."""
    del block  # the bound is per element; block only sets scale locality
    return world * x_amax / 254.0


def _generators(generator, n: int, stochastic: bool):
    if not stochastic:
        return [None] * n
    if generator is None or len(generator) != n:
        raise ValueError(f"stochastic rounding needs one torch.Generator "
                         f"per part ({n})")
    return list(generator)


def quantized_psum_scatter(parts: Sequence[torch.Tensor], *,
                           block: int = DEFAULT_BLOCK,
                           stochastic: bool = False,
                           generator: Optional[Sequence[torch.Generator]]
                           = None) -> List[torch.Tensor]:
    """Quantized reduce-scatter over one dp group.

    ``parts``: each device's fp32 [n], n % (len(parts) * block) == 0.
    Returns, for each part's device i, chunk i of the elementwise sum
    ([n / len(parts)], fp32): every part is quantized as [dp, n/dp], row i
    of each (int8 and its scales) moves to device i, which dequantizes the
    rows and adds them in rank order."""
    dp, n = len(parts), parts[0].shape[0]
    if n % (dp * block):
        raise ValueError(f"{dp} parts x block {block} do not tile {n}")
    gens = _generators(generator, dp, stochastic)
    rows = [quantize_int8_block(p.reshape(dp, n // dp), block, stochastic,
                                g) for p, g in zip(parts, gens)]
    out = []
    for i, part in enumerate(parts):
        dev = part.device
        total = None
        for q, scale in rows:
            x = dequantize_int8_block(q[i].to(dev), scale[i].to(dev), block)
            total = x if total is None else total.add_(x)
        out.append(total)
    return out


def quantized_all_gather(parts: Sequence[torch.Tensor], *,
                         block: int = DEFAULT_BLOCK,
                         stochastic: bool = False,
                         generator: Optional[Sequence[torch.Generator]]
                         = None) -> List[torch.Tensor]:
    """Quantized tiled all-gather over one dp group: each device's fp32
    shard [k] is quantized on its device, and every device gets the
    dequantized concatenation [len(parts) * k] in rank order (the order of
    ``lax.all_gather(tiled=True)``)."""
    gens = _generators(generator, len(parts), stochastic)
    qs = [quantize_int8_block(p, block, stochastic, g)
          for p, g in zip(parts, gens)]
    out = []
    for part in parts:
        dev = part.device
        q = torch.cat([q.to(dev) for q, _ in qs])
        scale = torch.cat([s.to(dev) for _, s in qs])
        out.append(dequantize_int8_block(q, scale, block))
    return out
