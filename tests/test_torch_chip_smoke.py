"""CPU tests of chip_smoke.py's helpers that phase 11's reproducibility
check rests on: the saved train state restores to the same trajectory every
time, the deterministic mode is scoped to its block, and bit-pattern
equality tells -0 from +0 in f32 and f64."""
import pytest
import torch

import chip_smoke


def _trainer(seed=0):
    gen = torch.Generator().manual_seed(seed)
    model = torch.nn.Sequential(torch.nn.Linear(6, 8), torch.nn.ReLU(),
                                torch.nn.Linear(8, 1))
    with torch.no_grad():
        for p in model.parameters():
            p.copy_(torch.randn(p.shape, generator=gen))
    optimizer = torch.optim.AdamW(model.parameters(), lr=1e-2,
                                  betas=(0.95, 0.99))
    scheduler = torch.optim.lr_scheduler.LambdaLR(
        optimizer, lambda step: 1.0 / (1 + step))
    x = torch.randn((32, 6), generator=gen)
    y = torch.randn((32, 1), generator=gen)

    def step():
        optimizer.zero_grad(set_to_none=True)
        loss = ((model(x) - y) ** 2).mean()
        loss.backward()
        optimizer.step()
        scheduler.step()
        return loss.item()
    return model, optimizer, scheduler, step


def test_saved_state_restores_the_same_trajectory():
    """Three steps, restore, the same three steps: equal losses and
    weights bit for bit, twice over (the optimizer keeps the state tensors
    it is given, so each restore must hand it a copy)."""
    model, optimizer, scheduler, step = _trainer()
    step()                                  # a state with moments in it
    restore = chip_smoke.saved_state(model, optimizer, scheduler)
    runs = []
    for _ in range(3):
        restore()
        losses = [step() for _ in range(3)]
        runs.append((losses, [p.detach().clone()
                              for p in model.parameters()]))
    for losses, params in runs[1:]:
        assert [v.hex() for v in losses] == [v.hex() for v in runs[0][0]]
        assert all(chip_smoke.same_bits(a, b)
                   for a, b in zip(params, runs[0][1]))


def test_deterministic_mode_is_scoped():
    """deterministic() turns torch's deterministic mode and deterministic
    cuDNN on inside its block only, and off again after an error."""
    assert not torch.are_deterministic_algorithms_enabled()
    with chip_smoke.deterministic():
        assert torch.are_deterministic_algorithms_enabled()
        assert torch.backends.cudnn.deterministic
        assert not torch.backends.cudnn.benchmark
    assert not torch.are_deterministic_algorithms_enabled()
    with pytest.raises(RuntimeError, match="inside"):
        with chip_smoke.deterministic():
            raise RuntimeError("inside")
    assert not torch.are_deterministic_algorithms_enabled()


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_same_bits_tells_signed_zeros_apart(dtype):
    a = torch.tensor([0.0, 1.5, -2.0], dtype=dtype)
    assert chip_smoke.same_bits(a, a.clone())
    assert not chip_smoke.same_bits(a, torch.tensor([-0.0, 1.5, -2.0],
                                                    dtype=dtype))
    assert not chip_smoke.same_bits(a, a.to(torch.float64 if dtype ==
                                            torch.float32 else
                                            torch.float32))
