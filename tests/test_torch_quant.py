"""repro_torch.models.quant against tests/test_quant.py's cases and against
the reference's repro.models.quant on the CPU: the int8 values and scales
bit-equal on the smollm, yi and mamba2 smoke configs with the reference's
parameters converted, at depths whose stacked norms hold exactly 4,096
elements (quantized by the reference's rule, though each layer alone holds
a few hundred) and one fewer layer (not quantized), the dequantized model
bit-equal, the storage bytes and the top-1 agreement equal, and
chip_smoke.QUANT_BYTES recomputed from the reference at full width through
jax.eval_shape and equal to the port's count on the meta device. Every
comparison is exact."""
import importlib.util
from pathlib import Path

import numpy as np
import pytest
import torch
from torch.overrides import TorchFunctionMode

from repro_torch.configs import get_config, get_smoke_config
from repro_torch.convert import model_params_from_jax, reference_leaves
from repro_torch.models import transformer as TT
from repro_torch.models.quant import (dequantize_tree, logit_agreement,
                                      quantize_tree, quantized_bytes)
from repro_torch.serving import Router, default_catalog, with_quantized_variants

ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module")
def jax():
    return pytest.importorskip("jax")


def _f32(cfg):
    return cfg.with_(dtype="float32", param_dtype="float32")


def _model(arch, seed, **over):
    cfg = get_smoke_config(arch, **over)
    return cfg, TT.init_params(cfg, torch.Generator().manual_seed(seed))


# ===========================================================================
# tests/test_quant.py's cases, on the port
# ===========================================================================

def test_quantization_roundtrip_error_bounded():
    cfg, model = _model("smollm_360m", 0)
    q, s = quantize_tree(model)
    deq = dequantize_tree(q, s, dtype=torch.float32)
    for (n, a), b in zip(model.named_parameters(), deq.parameters()):
        if s[n] is None:
            assert torch.equal(a, b)
        else:
            # per-channel int8: error ≤ scale/2 elementwise
            err = (a.double() - b.double()).abs()
            assert (err <= s[n].double() / 2 + 1e-8).all(), n


def test_quantized_storage_halves():
    _, model = _model("yi_34b", 1, param_dtype="bfloat16")
    q, s = quantize_tree(model)
    qb = quantized_bytes(q, s)
    fb = sum(p.numel() * 2 for p in model.parameters())  # bf16
    assert qb < 0.62 * fb, (qb, fb)


def test_quantized_model_agrees_with_reference():
    cfg, model = _model("smollm_360m", 2)
    cfg = _f32(cfg)
    q, s = quantize_tree(model)
    deq = dequantize_tree(q, s, dtype=torch.float32)
    agree = logit_agreement(cfg, model, deq, n_probes=4, seq=16)
    assert agree >= 0.75, f"int8 top-1 agreement too low: {agree}"


def test_placement_prefers_int8_when_storage_tight():
    from repro_torch.core import qos_matrix_np, sigma_np

    cat = with_quantized_variants(default_catalog())
    assert len(cat.models) == 2 * len(default_catalog().models)
    router = Router("egp", device="cpu")
    tight = cat.to_instance(150, 1, storage_capacity=45.0, seed=0)
    x_tight = router.place(tight)
    chosen_tight = {cat.models[p].arch for p in np.nonzero(x_tight[0])[0]}
    loose = cat.to_instance(150, 1, storage_capacity=2000.0, seed=0)
    x_loose = router.place(loose)
    assert any(a.endswith("-int8") for a in chosen_tight), chosen_tight
    chosen_loose = {cat.models[p].arch for p in np.nonzero(x_loose[0])[0]}
    assert any(not a.endswith("-int8") for a in chosen_loose)
    v_tight = sigma_np(tight, x_tight, qos_matrix_np(tight))
    v_loose = sigma_np(loose, x_loose, qos_matrix_np(loose))
    assert v_loose >= v_tight - 1e-9


# ===========================================================================
# against the reference
# ===========================================================================

def _np(a):
    a = np.asarray(a)
    return a.astype(np.float32) if a.dtype.name == "bfloat16" else a


def _stacked(tensors, leaf):
    got = [tensors[n] for n in leaf.names]
    t = torch.stack(got) if leaf.stacked else got[0]
    return (t.float() if t.dtype == torch.bfloat16 else t).numpy()


def _both(jax, arch, over, seed=0, dtype=None):
    from repro.configs import get_smoke_config as jsmoke
    from repro.models import transformer as JT

    jcfg, tcfg = jsmoke(arch).with_(**over), get_smoke_config(arch, **over)
    if dtype is not None:
        jcfg = jcfg.with_(dtype=dtype, param_dtype=dtype)
        tcfg = tcfg.with_(dtype=dtype, param_dtype=dtype)
    params = JT.init_params(jcfg, jax.random.PRNGKey(seed))
    model = model_params_from_jax(
        tcfg, jax.tree_util.tree_map(np.asarray, params))
    return jcfg, tcfg, params, model


CASES = [("smollm_360m", {}), ("yi_34b", {}), ("mamba2_2p7b", {}),
         ("yi_34b", {"n_layers": 32}), ("yi_34b", {"n_layers": 31}),
         ("mamba2_2p7b", {"n_layers": 64})]
IDS = ["smollm", "yi", "mamba2", "yi-norms-4096", "yi-norms-3968",
       "mamba2-norms-4096"]


@pytest.mark.parametrize("arch,over", CASES, ids=IDS)
def test_int8_values_and_scales_bit_equal_the_reference(jax, arch, over):
    from repro.models.quant import dequantize_tree as jdeq
    from repro.models.quant import quantize_tree as jquant
    from repro.models.quant import quantized_bytes as jbytes

    _, _, params, model = _both(jax, arch, over, dtype="bfloat16")
    jq, js = jquant(params)
    q, s = quantize_tree(model)
    leaves = reference_leaves(model)
    flat = jax.tree_util.tree_flatten_with_path(jq)[0]
    assert ["/".join(k.key for k in p) for p, _ in flat] == \
        [leaf.path for leaf in leaves]
    jscales = jax.tree_util.tree_leaves(js, is_leaf=lambda x: x is None)
    qs = dict(q.named_parameters())
    deq = dict(dequantize_tree(q, s).named_parameters())
    jdq = jax.tree_util.tree_leaves(jdeq(jq, js))
    n_quantized = 0
    for (_, want), sc, leaf, dq in zip(flat, jscales, leaves, jdq):
        assert np.array_equal(_stacked(qs, leaf), _np(want)), leaf.path
        assert str(qs[leaf.names[0]].dtype).endswith(
            str(np.asarray(want).dtype)), leaf.path
        assert np.array_equal(_stacked(deq, leaf), _np(dq)), leaf.path
        if sc is None:
            assert all(s[n] is None for n in leaf.names), leaf.path
            continue
        n_quantized += 1
        assert np.array_equal(_stacked(s, leaf), np.asarray(sc)), leaf.path
    assert n_quantized
    assert quantized_bytes(q, s) == int(jbytes(jq, js))
    norms = {leaf.path: sc is not None for leaf, sc in zip(leaves, jscales)}
    if over.get("n_layers") in (32, 64):      # L·d = 4,096: quantized
        assert norms["layers/ln1/scale" if arch == "yi_34b"
                     else "mamba/ln/scale"]
    if over.get("n_layers") == 31:            # 3,968: passes through
        assert not norms["layers/ln1/scale"]


@pytest.mark.parametrize("arch", ["smollm_360m", "mamba2_2p7b"])
def test_logit_agreement_equals_the_references(jax, arch):
    from repro.models.quant import dequantize_tree as jdeq
    from repro.models.quant import logit_agreement as jagree
    from repro.models.quant import quantize_tree as jquant

    jcfg, tcfg, params, model = _both(jax, arch, {}, seed=3,
                                      dtype="float32")
    jq, js = jquant(params)
    q, s = quantize_tree(model)
    for dtype, jdtype in ((torch.bfloat16, jax.numpy.bfloat16),
                          (torch.float32, jax.numpy.float32)):
        want = jagree(jcfg, params, jdeq(jq, js, dtype=jdtype),
                      n_probes=4, seq=16, seed=5)
        got = logit_agreement(tcfg, model, dequantize_tree(q, s, dtype),
                              n_probes=4, seq=16, seed=5)
        assert got == want, (dtype, got, want)
    # control: a model against itself
    assert logit_agreement(tcfg, model, model, n_probes=4, seq=16) == 1.0


class _OnMeta(TorchFunctionMode):
    """Every factory call on the meta device, without its generator."""

    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = dict(kwargs or {})
        if "device" in kwargs:
            kwargs["device"] = "meta"
        kwargs.pop("generator", None)
        return func(*args, **kwargs)


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_chip_smoke_quant_bytes_recomputed_from_the_reference(jax):
    from repro.configs import get_config as jget
    from repro.models import transformer as JT
    from repro.models.quant import quantize_tree as jquant
    from repro.models.quant import quantized_bytes as jbytes

    want = _chip_smoke().QUANT_BYTES
    assert set(want) == {"smollm_360m", "mamba2_2p7b"}
    for arch, n in want.items():
        cfg = jget(arch)
        shapes = jax.eval_shape(
            lambda: JT.init_params(cfg, jax.random.PRNGKey(0)))
        assert int(jbytes(*jax.eval_shape(jquant, shapes))) == n, arch
        with _OnMeta():
            model = TT.init_params(get_config(arch), torch.Generator())
        assert all(p.is_meta for p in model.parameters())
        assert quantized_bytes(*quantize_tree(model)) == n, arch
