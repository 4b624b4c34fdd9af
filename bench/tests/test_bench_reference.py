"""The plain reference against the port at a tiny size on the CPU, both
in float32 on the benchmark's weights: logits of a forward pass, and one
training step's loss and gradients."""
import json
from pathlib import Path

import pytest
import torch

from bench import port
from bench.reference import model as R
from bench.tests.tiny import TINY_CONFIG, TINY_HYBRID
from bench.weights import Weights

CONFIGS = Path(__file__).resolve().parents[1] / "configs"
TINY = {"mamba2-2p7b": TINY_CONFIG["mamba2-2p7b"], "hybrid": TINY_HYBRID}


def _cfg(name):
    cfg = json.loads((CONFIGS / "mamba2-2p7b.json").read_text())
    cfg.update(TINY[name], dtype="float32")
    return cfg


@pytest.mark.parametrize("name", sorted(TINY))
def test_forward_logits_match_the_port(name):
    from repro_torch.models import transformer as T

    cfg = _cfg(name)
    w = Weights(cfg, 2 ** 31 + 3, "cpu", block=4096).make()
    mc = port.model_config(cfg)
    model = port.build_model(mc, w)
    tok = torch.randint(0, cfg["vocab_size"], (2, 21),
                        generator=torch.Generator().manual_seed(1))
    with torch.no_grad():
        got = T.logits_fn(model, mc, T.forward(model, mc, tok,
                                               use_kernel=False))
        want = R.logits(w, cfg, R.hidden(w, cfg, tok))
    assert (got[..., :cfg["vocab_size"]] - want).abs().max() \
        <= 1e-5 * want.abs().max()


@pytest.mark.parametrize("name", sorted(TINY))
def test_loss_and_gradients_match_the_port(name):
    from repro_torch.models import transformer as T

    cfg = _cfg(name)
    wts = Weights(cfg, 11, "cpu", block=4096)
    mc = port.model_config(cfg)
    model = port.build_model(mc, wts.make())
    tok = torch.randint(0, cfg["vocab_size"], (2, 17),
                        generator=torch.Generator().manual_seed(2))
    batch = {"tokens": tok[:, :-1], "targets": tok[:, 1:]}
    loss = T.loss_fn(model, mc, batch, use_kernel=False)
    loss.backward()
    params = {n: t.detach().requires_grad_() for n, t in wts.make().items()}
    ref = R.loss(params, cfg, batch["tokens"], batch["targets"])
    ref.backward()
    assert abs(float(loss.detach()) - float(ref.detach())) \
        <= 1e-5 * abs(float(ref.detach()))
    for n, p in model.named_parameters():
        g, r = p.grad, params[n].grad
        assert (g - r).abs().max() <= 1e-4 * r.abs().max() + 1e-9, n


def test_fp8_control_rounds_every_product():
    x = torch.linspace(-3, 3, 101)[None]
    assert not torch.equal(R.fp8_round(x), x)
    assert (R.fp8_round(x) - x).abs().max() <= 3 / 448 * 448 / 16 + 1e-6
