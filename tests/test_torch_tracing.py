"""The step tracer (``noise_robust_vit_tpu_torch/train/tracing.py``) on the
CPU, on small robust SimpleViT and Swin builds: off by default; the step's
losses and parameters bit-identical with it on; one record a step, its four
boundaries in order and its three phases partitioning the step on both
clocks; consecutive step numbers; the ring; leads of 0 where the events are
host clocks; and no record of a step taken with the tracer unset."""

import math

import pytest
import torch

from noise_robust_vit_tpu_torch import create_model
from noise_robust_vit_tpu_torch.models import factory, swin
from noise_robust_vit_tpu_torch.train import StepTracer, create_train_state
from noise_robust_vit_tpu_torch.train.tracing import BOUNDARIES, PHASES

torch.set_num_threads(1)

SWIN = "tracing_test_swin"
MODELS = ("simple_vit", SWIN)
CPU = torch.device("cpu")


def _state(name: str, seed: int = 3, device=CPU):
    """A small robust model's train state on ``device``, its weights and
    stochastic-depth draws from ``seed``."""
    if SWIN not in factory._REGISTRY:
        @factory.register_model(SWIN)
        def _swin(num_classes, image_size, robust, dtype, device=None, **kw):
            return swin._swin([4, 4], 32, [2, 2], [2, 4], [4, 4], 0.2, 1,
                              num_classes=num_classes, robust=robust, dtype=dtype,
                              device=device)

    sizes = {"dim": 64, "depth": 2, "heads": 2, "mlp_dim": 128} if name == "simple_vit" else {}
    model = create_model(name, num_classes=10, image_size=16, robust=True, device=device,
                         seed=seed, **sizes)
    return create_train_state(model, lr=1e-3, weight_decay=0.05)


def _batches(n: int = 3, device=CPU):
    gen = torch.Generator().manual_seed(11)
    return [(torch.randn(4, 16, 16, 3, generator=gen).to(device),
             torch.randint(0, 10, (4,), generator=gen).to(device)) for _ in range(n)]


def _traced(name: str, steps: int = 3, untraced: int = 0):
    """``untraced`` steps, then ``steps`` with a started tracer; returns the
    state and the drain."""
    state = _state(name)
    batches = _batches(untraced + steps)
    for images, labels in batches[:untraced]:
        state.train_step(images, labels)
    state.tracer = StepTracer(CPU)
    state.tracer.start()
    for images, labels in batches[untraced:]:
        state.train_step(images, labels)
    return state, state.tracer.drain()


def test_tracer_is_off_by_default():
    assert _state("simple_vit").tracer is None


@pytest.mark.parametrize(
    "name,device", [*((n, "cpu") for n in MODELS),
                    *(pytest.param(n, "cuda", marks=pytest.mark.gpu) for n in MODELS)],
    ids=[*MODELS, *(f"{n}-cuda" for n in MODELS)])
def test_step_is_bit_identical_with_the_tracer_on(name, device):
    """Three states, the tracer off, on and off, take the same steps: losses
    and parameters bit for bit equal (on the card, through its kernels and
    CUDA events)."""
    if device == "cuda" and not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    device = torch.device(device)
    off, on, again = (_state(name, device=device) for _ in range(3))
    on.tracer = StepTracer(device)
    on.tracer.start()
    for images, labels in _batches(device=device):
        loss = off.train_step(images, labels)
        assert torch.equal(loss, on.train_step(images, labels))
        assert torch.equal(loss, again.train_step(images, labels))
    for (n, p), (m, q), (_, r) in zip(off.model.named_parameters(), on.model.named_parameters(),
                                      again.model.named_parameters()):
        assert n == m and torch.equal(p, q) and torch.equal(p, r), n
    assert off.step == on.step == again.step == 3
    assert len(on.tracer.drain()["records"]) == 3


@pytest.mark.parametrize("name", MODELS)
def test_one_record_a_step_whose_phases_partition_it(name):
    _, drained = _traced(name, steps=3, untraced=1)
    records = drained["records"]
    assert [r["step"] for r in records] == [1, 2, 3] and drained["steps"] == 3
    last = -math.inf
    for r in records:
        assert list(r["boundaries"]) == list(BOUNDARIES)
        assert list(r["phases"]) == list(PHASES)
        for clock in ("host_ms", "device_ms"):
            at = [r["boundaries"][b][clock] for b in BOUNDARIES]
            assert at == sorted(at) and at[0] >= 0.0
            phases = [r["phases"][p][clock] for p in PHASES]
            assert phases == [b - a for a, b in zip(at, at[1:])]
            assert math.isclose(sum(phases), at[-1] - at[0], rel_tol=1e-12, abs_tol=1e-12)
        assert r["boundaries"]["begin"]["host_ms"] >= last
        last = r["boundaries"]["optimizer_end"]["host_ms"]
        assert r["phases"]["forward"]["host_ms"] > 0 and r["phases"]["backward"]["host_ms"] > 0


@pytest.mark.parametrize("name", MODELS)
def test_every_lead_is_zero_on_the_cpu(name):
    _, drained = _traced(name, steps=2)
    assert drained["drift_ms"] == 0.0
    for r in drained["records"]:
        for b in BOUNDARIES:
            assert r["boundaries"][b]["lead_ms"] == 0.0
            assert r["boundaries"][b]["device_ms"] == r["boundaries"][b]["host_ms"]


def _mark_steps(tracer: StepTracer, steps) -> None:
    for n in steps:
        for b in BOUNDARIES:
            tracer.mark(b, n)


def test_ring_keeps_the_last_steps_and_drain_empties_it():
    tracer = StepTracer(CPU, capacity_steps=2)
    tracer.start()
    _mark_steps(tracer, range(5))
    drained = tracer.drain()
    assert [r["step"] for r in drained["records"]] == [3, 4] and drained["steps"] == 5
    again = tracer.drain()
    assert again["records"] == [] and again["steps"] == 0
    tracer.start()
    _mark_steps(tracer, [7])
    assert [r["step"] for r in tracer.drain()["records"]] == [7]


def test_a_step_not_closed_is_left_out():
    tracer = StepTracer(CPU)
    tracer.start()
    _mark_steps(tracer, [0])
    tracer.mark("begin", 1)
    tracer.mark("forward_end")
    drained = tracer.drain()
    assert [r["step"] for r in drained["records"]] == [0] and drained["steps"] == 1


def test_drain_before_start_raises():
    with pytest.raises(RuntimeError, match="before start"):
        StepTracer(CPU).drain()


@pytest.mark.parametrize("name", MODELS)
def test_only_the_steps_taken_with_the_tracer_set_are_recorded(name):
    state = _state(name)
    tracer = StepTracer(CPU)
    tracer.start()
    for k, (images, labels) in enumerate(_batches(4)):
        state.tracer = tracer if k in (0, 2) else None
        state.train_step(images, labels)
    drained = tracer.drain()
    assert [r["step"] for r in drained["records"]] == [0, 2] and drained["steps"] == 2
    assert state.step == 4
