"""Reference-matching initialisation distributions on a ``torch.Generator``.

The reference initialises every embedding coordinate with a rejection-sampled
truncated normal ``randn(miu, sigma, min, max)`` (``common/utils.cpp:26-38``)
driven by the C ``rand()`` chain.  Like ``kb2e_tpu.utils.prng`` we keep the
*distribution*, not the bits: the draws come from an explicit
``torch.Generator`` and differ from JAX's threefry draws for the same seed.

* TransE init: randn(0, 1/k, -6/sqrt(k), 6/sqrt(k))  (transe/trainer.cpp:21-23)
* TransH/TransR init: randn(0, 1/k, -1, 1)           (transh/trainer.cpp:61-63,
                                                      transr/trainer.cpp:67-69)
"""

from __future__ import annotations

import torch


def truncated_normal(
    generator: torch.Generator,
    shape,
    sigma: float,
    low: float,
    high: float,
    device,
    dtype=torch.float32,
) -> torch.Tensor:
    """Normal(0, sigma) truncated to [low, high] (bounds in data units).

    Drawn on the generator's own device and then moved to ``device``, so a
    seed gives the same table whichever device it lands on.
    """
    out = torch.empty(shape, dtype=torch.float32, device=generator.device)
    torch.nn.init.trunc_normal_(out, mean=0.0, std=sigma, a=low, b=high, generator=generator)
    return out.to(device=device, dtype=dtype)


def transe_init(generator: torch.Generator, shape, embedding_size: int, device, dtype=torch.float32) -> torch.Tensor:
    """Reference TransE init distribution (transe/trainer.cpp:21-23)."""
    k = embedding_size
    return truncated_normal(
        generator, shape, sigma=1.0 / k, low=-6.0 / k**0.5, high=6.0 / k**0.5, device=device, dtype=dtype
    )


def unit_bounded_init(generator: torch.Generator, shape, embedding_size: int, device, dtype=torch.float32) -> torch.Tensor:
    """Reference TransH/TransR init distribution (randn(0, 1/k, -1, 1))."""
    k = embedding_size
    return truncated_normal(generator, shape, sigma=1.0 / k, low=-1.0, high=1.0, device=device, dtype=dtype)
