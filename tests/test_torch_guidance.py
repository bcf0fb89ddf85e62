"""Classifier guidance in the port against the JAX package (CPU, float32).

The classifiers are XS-sized DiTRotaryClassifiers (hidden 64, depth 2,
2 heads): JAX initialises them, every parameter is perturbed by seeded
numpy noise (so the adaLN-Zero gates and the heads are real functions),
and ``convert.classifier_state_dict`` loads the same values into the port.
JAX runs under ``default_matmul_precision("highest")``. Tolerances: logits
and log-probs within 1e-4 (fp32 through two blocks; observed ~2e-6);
gradients within 1e-4 of the gradient's largest magnitude.

Also here: the gradient of the flash-attention wrapper (its autograd
Function, with the plain version standing in for the kernel launch, which
needs the card), and the sampler's and the config's handling of guidance.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rule_guided_music_tpu.diffusion import guidance as jguidance
from rule_guided_music_tpu.models import DiT_models as JaxDiT
from rule_guided_music_tpu.models.dit import DiTRotaryClassifier as JaxClassifier
from rule_guided_music_tpu.models.torch_port import convert_dit_rotary_classifier
from rule_guided_music_tpu.utils.fixtures import flatten_tree, make_rolls, unflatten_tree
from rule_guided_music_tpu_torch import config as tconfig
from rule_guided_music_tpu_torch import convert, pipeline
from rule_guided_music_tpu_torch.diffusion import guidance as tguidance
from rule_guided_music_tpu_torch.diffusion import sampling as tsampling
from rule_guided_music_tpu_torch.diffusion import schedule as tschedule
from rule_guided_music_tpu_torch.models.dit import DiT_models, DiTRotaryClassifier
from rule_guided_music_tpu_torch.ops import flash_attention as fa

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CLS_SIZE = dict(hidden_size=64, depth=2, num_heads=2)
TOL = dict(rtol=1e-4, atol=1e-4)
# scg_classifier_all.yml's three terms
FLAGSHIP_TERMS = (("grad_nn_zt_mse", "pitch_hist", 400.0, 12, False),
                  ("grad_nn_zt_mse", "note_density", 10.0, 16, False),
                  ("grad_nn_zt_chord", "chord_progression", 10.0, 8, True))


def perturbed_flat(params, seed, scale=0.05):
    flat = flatten_tree(jax.tree_util.tree_map(np.asarray, params))
    rng = np.random.default_rng(seed)
    return {k: (v + scale * rng.standard_normal(v.shape)).astype(np.float32)
            for k, v in flat.items()}


def as_jax_params(flat):
    tree = unflatten_tree({k[len("params/"):]: v for k, v in flat.items()})
    return {"params": jax.tree_util.tree_map(jnp.asarray, tree)}


def paired_classifier(num_classes, chord, seed):
    """(JAX apply closure, port module) holding the same random weights."""
    jmodel = JaxClassifier(num_classes=num_classes, chord=chord, **CLS_SIZE)
    params = jmodel.init(jax.random.PRNGKey(seed), jnp.zeros((1, 4, 128, 16)),
                         jnp.zeros((1,)))
    flat = perturbed_flat(params, seed)
    jparams = as_jax_params(flat)
    model = DiTRotaryClassifier(num_classes=num_classes, chord=chord, **CLS_SIZE)
    model.load_state_dict(convert.classifier_state_dict(flat), strict=True)
    model.eval().requires_grad_(False)
    return (lambda x, t: jmodel.apply(jparams, x, t)), model


def flagship_specs(seed=0):
    """The three cond_fn terms of scg_classifier_all.yml, in both frameworks."""
    jspecs, metas = [], []
    for i, (fn, rule, scale, ncls, chord) in enumerate(FLAGSHIP_TERMS):
        jcls, tcls = paired_classifier(ncls, chord, seed + i)
        jspecs.append(jguidance.CondFnSpec(fn=fn, rule_name=rule, scale=scale,
                                           classifier=jcls))
        metas.append(pipeline.ClassifierSpecMeta(fn=fn, rule_name=rule,
                                                 scale=scale, model=tcls))
    return jspecs, metas


def flagship_rules(rolls):
    from rule_guided_music_tpu.rules.registry import FUNC_DICT as JFUNC

    names = [rule for _, rule, _, _, _ in FLAGSHIP_TERMS]
    jrules = {n: JFUNC[n](jnp.asarray(rolls)) for n in names}
    trules = pipeline.extract_targets_from_rolls(names, torch.as_tensor(rolls))
    return jrules, trules


def latents(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


@pytest.mark.parametrize("chord", [False, True], ids=["plain", "chord"])
def test_classifier_matches_jax(chord):
    jcls, tcls = paired_classifier(8, chord, seed=3)
    x = latents((3, 4, 128, 16), 1)
    t = np.array([0.0, 250.0, 999.0], np.float32)
    with jax.default_matmul_precision("highest"):
        ref = jcls(jnp.asarray(x), jnp.asarray(t))
    with torch.no_grad():
        out = tcls(torch.as_tensor(x), torch.as_tensor(t))
    ref, out = (ref, out) if chord else ((ref,), (out,))
    shapes = [(3, 25), (3, 8, 8)] if chord else [(3, 8)]
    for o, r, shape in zip(out, ref, shapes):
        assert o.dtype == torch.float32 and tuple(o.shape) == shape
        np.testing.assert_allclose(o.numpy(), np.asarray(r), **TOL)


@pytest.mark.parametrize("name", ["DiTRotary-XS/8-cls", "DiTRotary-S/8-cls",
                                  "DiTRotary-S/8-chord-cls", "DiTRotary-B/8-cls"])
def test_classifier_state_dict_is_the_reference_layout(name):
    """The registry's widths; the JAX package's torch->flax converter
    (written against the reference's names) takes the port's state_dict,
    and classifier_state_dict maps its tree back key for key (strict)."""
    widths = {"DiTRotary-XS/8-cls": (4, 384, 6), "DiTRotary-S/8-cls": (12, 384, 6),
              "DiTRotary-S/8-chord-cls": (12, 384, 6),
              "DiTRotary-B/8-cls": (12, 768, 12)}[name]
    with torch.device("meta"):
        meta = DiT_models[name](num_classes=8)
    assert (len(meta.blocks), meta.hidden_size, meta.num_heads) == widths
    chord = "chord" in name
    model = DiTRotaryClassifier(num_classes=8, chord=chord, **CLS_SIZE)
    sd = {k: v.numpy() for k, v in model.state_dict().items()}
    tree = convert_dit_rotary_classifier(sd, depth=2, chord=chord)["params"]
    back = convert.classifier_state_dict(flatten_tree(tree))
    assert set(back) == set(sd)
    fresh = DiTRotaryClassifier(num_classes=8, chord=chord, **CLS_SIZE)
    fresh.load_state_dict(back, strict=True)
    for k in sd:
        np.testing.assert_array_equal(back[k].numpy(), sd[k])


def _program_case(fn):
    """(classifier args, rule name, targets, x) for one cond_fn name."""
    rng = np.random.default_rng(7)
    if fn.startswith("rule_x0"):
        return None, "pitch_hist", rng.random((2, 12)).astype(np.float32), \
            make_rolls(2, seed=3)
    x = latents((2, 4, 128, 16), 8)
    if "chord" in fn:
        return (8, True), "chord_progression", rng.integers(0, 8, (2, 8)).astype(np.int32), x
    if "xentropy" in fn:
        return (5, False), "nd_class", rng.integers(0, 5, (2, 1)).astype(np.int32), x
    return (12, False), "pitch_hist", rng.standard_normal((2, 12)).astype(np.float32), x


@pytest.mark.parametrize("fn", tguidance.COND_FN_NAMES)
def test_cond_fn_programs_match_jax(fn):
    assert tguidance.COND_FN_NAMES == jguidance.COND_FN_NAMES
    cls_args, rule_name, target, x = _program_case(fn)
    jcls = tcls = None
    if cls_args is not None:
        jcls, tcls = paired_classifier(*cls_args, seed=11)
    t = np.array([40.0, 700.0], np.float32)
    jspec = jguidance.CondFnSpec(fn=fn, rule_name=rule_name, scale=3.0,
                                 classifier=jcls)
    tspec = tguidance.CondFnSpec(fn=fn, rule_name=rule_name, scale=3.0,
                                 classifier=tcls)
    with jax.default_matmul_precision("highest"):
        ref = jspec.logprob(jnp.asarray(x), jnp.asarray(t),
                            {rule_name: jnp.asarray(target)})
    with torch.no_grad():
        out = tspec.logprob(torch.as_tensor(x), torch.as_tensor(t),
                            {rule_name: torch.as_tensor(target)})
    assert tuple(out.shape) == (2,)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)
    value = tguidance.make_value_cond_fn([tspec, tspec])
    with torch.no_grad():
        np.testing.assert_allclose(
            value(torch.as_tensor(x), torch.as_tensor(t),
                  {rule_name: torch.as_tensor(target)}).numpy(),
            2 * np.asarray(ref), **TOL)


@pytest.mark.parametrize("cfg,class_cond,with_y", [(False, True, True),
                                                   (True, True, True),
                                                   (False, True, False),
                                                   (False, False, True)])
def test_make_model_fn_matches_jax(cfg, class_cond, with_y):
    """Class labels, the null id num_classes, and CFG in one batched call."""
    jmodel = JaxDiT["DiTRotary_XS_8"](input_size=(128, 16), in_channels=4,
                                     num_classes=3)
    x = latents((2, 4, 128, 16), 4)
    t = np.array([5.0, 600.0], np.float32)
    y = np.array([0, 2], np.int32)
    params = jmodel.init(jax.random.PRNGKey(1), jnp.asarray(x), jnp.asarray(t),
                         jnp.asarray(y))
    flat = perturbed_flat(params, 5)
    jparams = as_jax_params(flat)
    model = DiT_models["DiTRotary_XS_8"](num_classes=3)
    model.load_state_dict(convert.dit_state_dict(flat))
    jfn = jguidance.make_model_fn(lambda a, b, c: jmodel.apply(jparams, a, b, c),
                                  3, class_cond=class_cond, cfg=cfg, w=2.5)
    tfn = tguidance.make_model_fn(model, 3, class_cond=class_cond, cfg=cfg, w=2.5)
    with jax.default_matmul_precision("highest"):
        ref = jfn(jnp.asarray(x), jnp.asarray(t),
                  jnp.asarray(y) if with_y else None)
    with torch.no_grad():
        out = tfn(torch.as_tensor(x), torch.as_tensor(t),
                  torch.as_tensor(y) if with_y else None)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)


def test_grad_cond_fn_matches_jax_grad():
    """The flagship composite (mse, mse, chord; scales 400/10/10) through
    make_grad_cond_fn against jax.grad, from inside no_grad as generate
    calls it."""
    jspecs, metas = flagship_specs()
    jrules, trules = flagship_rules(make_rolls(2, seed=5))
    x = latents((2, 4, 128, 16), 9)
    t = np.array([120.0, 743.0], np.float32)
    with jax.default_matmul_precision("highest"):
        ref = np.asarray(jguidance.make_grad_cond_fn(jspecs)(
            jnp.asarray(x), jnp.asarray(t), jrules))
    cond_fn = tguidance.make_grad_cond_fn([
        tguidance.CondFnSpec(fn=m.fn, rule_name=m.rule_name, scale=m.scale,
                             classifier=m.model) for m in metas])
    with torch.no_grad():
        out = cond_fn(torch.as_tensor(x), torch.as_tensor(t), trules)
    assert out.shape == x.shape and not out.requires_grad
    scale = np.abs(ref).max()
    assert scale > 0
    np.testing.assert_allclose(out.numpy(), ref, rtol=0, atol=1e-4 * scale)


def _attention_inputs(layout, dtype, requires_grad=True):
    b, n, h, d = 2, 9, 3, 8
    gen = torch.Generator().manual_seed(0)
    if layout == "qkv views":
        qkv = torch.randn((b, n, 3, h, d), generator=gen).to(dtype)
        qkv.requires_grad_(requires_grad)
        return (qkv,), qkv.unbind(2)
    leaves = tuple(torch.randn((b, n, h, d), generator=gen).to(dtype)
                   .requires_grad_(requires_grad) for _ in range(3))
    return leaves, leaves


@pytest.mark.parametrize("layout", ["contiguous", "qkv views"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention_backward_replays_reference(monkeypatch, layout, dtype):
    """_FlashAttention with plain versions standing in for the kernels (they
    need the card): the forward's LSE and output reach the backward, and
    the gradients it returns are the plain version's, in each leaf's shape
    and dtype, a strided v (a view of qkv) included. The stand-in for the
    backward launch is the VJP of the plain forward on the saved inputs."""
    saved = []

    def launch(q, k, v, lse=None):
        out, ref_lse = fa.flash_attention_reference_lse(q, k, v)
        lse.copy_(ref_lse)
        return out

    def launch_bwd(q, k, v, out, lse, dout):
        saved.append((out, lse, fa.flash_attention_reference_lse(q, k, v)))
        with torch.enable_grad():
            inputs = [t.detach().float().requires_grad_() for t in (q, k, v)]
            grads = torch.autograd.grad(fa.flash_attention_reference(*inputs),
                                        inputs, dout.float())
        return tuple(g.to(q.dtype) for g in grads)

    monkeypatch.setattr(fa, "_launch", launch)
    monkeypatch.setattr(fa, "_launch_bwd", launch_bwd)
    cot = torch.randn((2, 9, 3, 8), generator=torch.Generator().manual_seed(1))
    grads = []
    for use_function in (True, False):
        leaves, (q, k, v) = _attention_inputs(layout, dtype)
        if layout == "qkv views":
            assert not v.is_contiguous()
        out = (fa._FlashAttention.apply(q, k, v) if use_function
               else fa.flash_attention_reference(q, k, v))
        grads.append(torch.autograd.grad(out, leaves, cot.to(dtype)))
    for got, want in zip(*grads):
        assert got.shape == want.shape and got.dtype == want.dtype == dtype
        torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-6)
    (out, lse, (ref_out, ref_lse)), = saved
    assert lse.shape == (2, 3, 9) and lse.dtype == torch.float32
    torch.testing.assert_close(out, ref_out, rtol=0, atol=0)
    torch.testing.assert_close(lse, ref_lse, rtol=0, atol=0)


def test_flash_attention_enters_the_function_only_for_a_gradient(monkeypatch):
    """The dispatch of the card path: the autograd Function where grad mode
    is on and an input wants a gradient, a bare launch otherwise."""
    calls = []

    def launch(q, k, v, lse=None):
        calls.append(torch.is_grad_enabled())
        return fa.flash_attention_reference(q, k, v)

    monkeypatch.setattr(fa, "_launch", launch)
    _, (q, k, v) = _attention_inputs("qkv views", torch.float32)
    assert fa._dispatch(q, k, v).grad_fn.name() == "_FlashAttentionBackward"
    with torch.no_grad():
        assert fa._dispatch(q, k, v).grad_fn is None
    _, (q, k, v) = _attention_inputs("contiguous", torch.float32,
                                     requires_grad=False)
    assert fa._dispatch(q, k, v).grad_fn is None
    with torch.inference_mode():
        assert fa._dispatch(q, k, v).grad_fn is None
    # inside the Function's forward grad mode is off; a bare launch keeps it
    assert calls == [False, False, True, False]


def test_config_accepts_the_flagship_and_refuses_dps():
    cfg = tconfig.load_config(os.path.join(
        REPO, "scripts", "configs", "cond_table", "all", "scg_classifier_all.yml"))
    sc = tconfig.sampler_config_from_yaml(
        cfg, rule_names=["pitch_hist", "note_density", "chord_progression"])
    assert sc.guidance.method == "classifier_guidance"
    assert sc.scg.num_samples == 16 and sc.sampler == "ddpm"
    # DPS is ported: the loader takes its step size and switches
    dps = tconfig.load_config(os.path.join(
        REPO, "scripts", "configs", "cond_table", "single", "dps_nn", "pitch.yml"))
    sc = tconfig.sampler_config_from_yaml(dps, rule_names=["pitch_hist"])
    assert sc.guidance.method == "dps" and sc.guidance.step_size == 1.0
    assert sc.guidance.nn


def test_sampler_refuses_dps_and_keeps_the_schedule_mask():
    """DDIM takes no DPS step, as the JAX package's loop skips a DPS
    cond_fn there (sampling.py:660); DDPM calls it on every step."""
    assert tsampling.guide_schedule_mask is tguidance.guide_schedule_mask
    tables = tschedule.make_schedule("linear", 1000, "2").tables("cpu")
    calls = []

    def cond_fn(x0, t, rules):
        calls.append(x0.shape)
        return -(x0 ** 2).sum(dim=(1, 2, 3)) - 1.0

    for sampler, want in (("ddim", 0), ("ddpm", 2)):
        config = tconfig.SamplerConfig(
            sampler=sampler, guidance=tconfig.GuidanceConfig(method="dps", nn=True))
        calls.clear()
        tsampling.sample_loop(
            lambda x, t, y: 0.5 * x, (1, 4, 8, 8), tables, config,
            noise_fn=tsampling.torch_noise_fn(None, "cpu"), cond_fn=cond_fn)
        assert len(calls) == want, sampler


def test_build_classifier_bundles_warns_and_seeds(capsys):
    from types import SimpleNamespace

    cc = SimpleNamespace(names=["DiTRotary-XS/8-cls"] * 2, num_classes=[12, 12],
                         paths=["", "no/such/file"])
    first = pipeline.build_classifier_bundles(cc, dtype=torch.float32, device="cpu")
    again = pipeline.build_classifier_bundles(cc, dtype=torch.float32, device="cpu")
    assert capsys.readouterr().err.count("seeded random weights") == 4
    for a, b in zip(first, again):
        assert not any(p.requires_grad for p in a.parameters())
        assert not a.training
        for pa, pb in zip(a.parameters(), b.parameters()):
            torch.testing.assert_close(pa, pb, rtol=0, atol=0)
    # seeds 100 + i: the two classifiers differ
    assert not torch.equal(first[0].cls_token, first[1].cls_token)
