"""Small shared helpers (counterpart of ``noise_robust_vit_tpu/utils``):
``pair``, the entry points' device rule, and flax's initializers as
in-place fills drawn from an explicit ``torch.Generator``."""

from __future__ import annotations

import math

import torch

__all__ = ["lecun_normal_init", "normal_init", "pair", "resolve_device",
           "trunc_normal_init", "xavier_uniform_init", "zeros_init"]


def pair(t):
    """``t`` as an ``(h, w)`` pair (ref simple_vit.py:11-12)."""
    return t if isinstance(t, tuple) else (t, t)


def resolve_device(device: torch.device | str | None) -> torch.device:
    """The entry points' device: the card unless the caller names another
    (``device="cpu"``). With no card and no device named this raises; it
    never falls back to the CPU."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: the port builds its models on the card "
                           "unless the caller passes device='cpu'")
    return torch.device("cuda")


# An initializer fills a parameter in place: ``init(tensor, generator)``.
# Dense weights are [out, in] (torch's layout); fans are read from that.

def lecun_normal_init():
    """flax's default Dense kernel init: variance 1/fan_in, truncated at ±2σ."""
    def init(w, generator):
        std = math.sqrt(1.0 / w.shape[1]) / 0.87962566103423978
        torch.nn.init.trunc_normal_(w, std=std, a=-2 * std, b=2 * std, generator=generator)
    return init


def trunc_normal_init(std: float = 0.02, mean: float = 0.0, a: float = -2.0,
                      b: float = 2.0):
    """timm's ``trunc_normal_`` (JAX ``utils.trunc_normal_init``): normal
    (mean, std) truncated to the *absolute* interval [a, b]."""
    def init(w, generator):
        torch.nn.init.trunc_normal_(w, mean=mean, std=std, a=a, b=b, generator=generator)
    return init


def xavier_uniform_init():
    """flax ``xavier_uniform``: U(±√(6 / (fan_in + fan_out)))."""
    def init(w, generator):
        torch.nn.init.xavier_uniform_(w, generator=generator)
    return init


def normal_init(std: float):
    def init(w, generator):
        torch.nn.init.normal_(w, std=std, generator=generator)
    return init


def zeros_init():
    def init(w, generator):
        w.zero_()
    return init
