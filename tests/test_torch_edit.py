"""Excerpt editing in the port against the JAX package (CPU, float32): the
VAE encoder, the edit branch of the Gaussian math, an edit chain with SCG,
the DDIM reverse loop, the edit targets and the edit CLI.

The committed ``quality_tiny.npz`` holds trained encoder weights: a pixel
shift from a wrong ``Downsample`` pad gives a plausible latent there that
the comparison catches. Tolerances: the models' fp32 summation order,
held to 1e-4 (``MODEL_TOL``); encoded latent images to 1e-4 of their
largest magnitude (``encoded_close``: on 16 chunks JAX's fp32 CPU
convolutions land 1.4e-4 from a float64 evaluation of the same encoder,
the port 2.6e-6); chains as in ``test_torch_scg_chain``.
"""

import csv
import os
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from rule_guided_music_tpu.diffusion import gaussian as jgd
from rule_guided_music_tpu.diffusion import sampling as jsampling
from rule_guided_music_tpu.diffusion import schedule as jschedule
from rule_guided_music_tpu.diffusion.latent import make_decode_fn as jmake_decode
from rule_guided_music_tpu.diffusion.latent import make_encode_fn as jmake_encode
from rule_guided_music_tpu.models import AutoencoderKL as JaxVAE
from rule_guided_music_tpu.models import DiT_models as JaxDiT
from rule_guided_music_tpu.models.torch_port import convert_vae
from rule_guided_music_tpu.models.vae import Downsample as JaxDownsample
from rule_guided_music_tpu.rules.registry import FUNC_DICT as JFUNC
from rule_guided_music_tpu.utils.fixtures import flatten_tree, load_fixture_npz, make_rolls
from rule_guided_music_tpu_torch import config as tconfig
from rule_guided_music_tpu_torch import convert, edit, pipeline
from rule_guided_music_tpu_torch.data.midi_io import read_midi
from rule_guided_music_tpu_torch.diffusion import gaussian as tgd
from rule_guided_music_tpu_torch.diffusion import latent as tlatent
from rule_guided_music_tpu_torch.diffusion import sampling as tsampling
from rule_guided_music_tpu_torch.diffusion import schedule as tschedule
from rule_guided_music_tpu_torch.models.vae import (AutoencoderKL, Downsample,
                                                    FusedNormSwish)
from scripts.edit import resolve_edit_targets as jresolve_edit_targets

from test_torch_scg_chain import jax_replay_noise

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURE = os.path.join(REPO, "tests", "fixtures", "quality_tiny.npz")
EDIT_YAMLS = os.path.join(REPO, "scripts", "configs", "edit")
TINY_VAE = dict(ch=32, ch_mult=(1, 1, 2, 2), num_res_blocks=1)
TINY_VAE_ARCH = '{"ch": 32, "ch_mult": [1, 1, 2, 2], "num_res_blocks": 1}'
MODEL_TOL = dict(rtol=1e-4, atol=1e-4)
WEIGHTS = (("pitch_hist", 40.0), ("note_density", 1.0), ("chord_progression", 1.0))


@pytest.fixture(autouse=True, scope="module")
def few_threads():
    """The suite runs several workers on one machine; torch's default of a
    thread per core makes the conv-heavy chains here contend badly there."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def encoded_close(got, want):
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=1e-4 * np.abs(want).max())


@pytest.fixture(scope="module")
def fx():
    return load_fixture_npz(FIXTURE)


def _tiny_vae():
    return pipeline.create_vae(FIXTURE, arch=TINY_VAE, encoder=True,
                               dtype=torch.float32, device="cpu")


def test_downsample_pads_right_and_bottom():
    """The port's Downsample equals JAX's (0, 1) pad + stride-2 valid conv
    on shared weights; a symmetric padding=1 conv gives another result."""
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 8, 16, 16)).astype(np.float32)
    kernel = rng.standard_normal((3, 3, 8, 8)).astype(np.float32) / 8
    bias = rng.standard_normal(8).astype(np.float32)
    ref = JaxDownsample().apply({"params": {"conv": {"kernel": kernel, "bias": bias}}},
                                jnp.asarray(x.transpose(0, 2, 3, 1)))
    ref = np.asarray(ref).transpose(0, 3, 1, 2)
    down = Downsample(8)
    down.load_state_dict(convert._convert({"conv/kernel": kernel, "conv/bias": bias},
                                          []))
    with torch.no_grad():
        out = down(torch.as_tensor(x)).numpy()
        symmetric = F.conv2d(torch.as_tensor(x), down.conv.weight,
                             down.conv.bias, stride=2, padding=1).numpy()
    assert out.shape == ref.shape == (2, 8, 8, 8)
    np.testing.assert_allclose(out, ref, rtol=1e-5, atol=1e-5)
    assert np.abs(symmetric - ref).max() > 0.1


def test_encoder_matches_jax_on_fixture(fx):
    """The trained quality_tiny encoder + quant_conv on three chunks of
    real-looking rolls."""
    x = make_rolls(1, length=384, seed=3)
    x = np.concatenate([x[..., i * 128:(i + 1) * 128] for i in range(3)])
    with jax.default_matmul_precision("highest"):
        ref = np.asarray(JaxVAE(**TINY_VAE).apply(
            fx["vae"], jnp.asarray(x), method=JaxVAE.encode_moments))
    with torch.no_grad():
        out = _tiny_vae().encode_moments(torch.as_tensor(x)).numpy()
    assert out.shape == ref.shape == (3, 8, 16, 16)
    np.testing.assert_allclose(out, ref, **MODEL_TOL)


def test_make_encode_fn_matches_jax(fx):
    """Long rolls -> latent images through chunking, the posterior mode and
    the scale factor, then the pixel/latent bridges alone."""
    rolls = make_rolls(2, seed=11)
    jenc = jmake_encode(lambda c: JaxVAE(**TINY_VAE).apply(
        fx["vae"], c, method=JaxVAE.encode_moments), scale_factor=fx["scale"])
    with jax.default_matmul_precision("highest"):
        ref = np.asarray(jenc(jnp.asarray(rolls)))
    out = pipeline.encode_rolls(_tiny_vae(), torch.as_tensor(rolls), fx["scale"])
    assert out.shape == ref.shape == (2, 4, 128, 16)
    assert not out.requires_grad and not out.is_inference()
    encoded_close(out.numpy(), ref)

    from rule_guided_music_tpu.diffusion import latent as jlatent
    pix = np.random.default_rng(2).standard_normal((2, 3, 8, 64)).astype(np.float32)
    np.testing.assert_array_equal(
        tlatent.pixels_to_chunks(torch.as_tensor(pix)).numpy(),
        np.asarray(jlatent.pixels_to_chunks(jnp.asarray(pix))))
    z = np.random.default_rng(3).standard_normal((8, 4, 4, 4)).astype(np.float32)
    np.testing.assert_array_equal(
        tlatent.chunks_to_latent(torch.as_tensor(z), 4).numpy(),
        np.asarray(jlatent.chunks_to_latent(jnp.asarray(z), 4)))


def test_encoder_production_geometry_matches_jax():
    """ch 128, ch_mult (1,2,2,4) with seeded random weights on one chunk:
    the port's state_dict goes through the JAX package's torch converter
    (the reference's names) into the JAX VAE, and back through
    ``convert.vae_state_dict`` unchanged."""
    vae = pipeline.randomize_(AutoencoderKL(encoder=True), seed=4)
    sd = {k: v.numpy() for k, v in vae.state_dict().items()}
    tree = convert_vae(sd)
    back = convert.vae_state_dict(flatten_tree(tree["params"]), encoder=True)
    assert set(back) == set(sd)
    for k in sd:
        np.testing.assert_array_equal(back[k].numpy(), sd[k])
    x = make_rolls(1, length=128, seed=9)
    with jax.default_matmul_precision("highest"):
        ref = np.asarray(JaxVAE().apply(tree, jnp.asarray(x),
                                        method=JaxVAE.encode_moments))
    with torch.no_grad():
        out = vae.encode_moments(torch.as_tensor(x)).numpy()
    assert out.shape == (1, 8, 16, 16)
    # 21 GroupNorms at widths up to 512: fp32 summation order, relative
    np.testing.assert_allclose(out, ref, rtol=1e-4, atol=1e-4 * np.abs(ref).max())


def test_encoder_is_built_only_on_request():
    """Decode-only VAEs keep their parameters and launch counts; the
    production encoder has 21 GroupNorm+swish calls per encode."""
    with torch.device("meta"):
        plain, full = AutoencoderKL(), AutoencoderKL(encoder=True)
    assert plain.encoder is None
    assert not any(k.startswith(("encoder.", "quant_conv."))
                   for k in plain.state_dict())
    assert set(plain.state_dict()) < set(full.state_dict())
    count = lambda m: sum(isinstance(x, FusedNormSwish) for x in m.modules())
    assert count(plain) == 29 and count(full.encoder) == 21
    with pytest.raises(ValueError, match="encoder=True"):
        plain.encode_moments(torch.zeros((1, 3, 128, 128), device="meta"))
    # the fixture's npz loads into both
    assert pipeline.create_vae(FIXTURE, arch=TINY_VAE, dtype=torch.float32,
                               device="cpu").encoder is None


@pytest.mark.parametrize("mean_type", ["EPSILON", "START_X"])
def test_p_mean_variance_edit_branch_matches_jax(mean_type):
    rng = np.random.default_rng(7)
    shape = (2, 4, 32, 16)
    out, x, gt = (rng.standard_normal(shape).astype(np.float32) for _ in range(3))
    mask = np.zeros(shape, np.float32)
    mask[:, :, :8] = 1.0
    t = np.array([3, 9])
    jt = jschedule.make_schedule("linear", 1000, "10").tables()
    tt = tschedule.make_schedule("linear", 1000, "10").tables("cpu")
    ref = jgd.p_mean_variance(jt, jnp.asarray(out), jnp.asarray(x), jnp.asarray(t),
                              mean_type=getattr(jgd.ModelMeanType, mean_type),
                              edit_mask=jnp.asarray(mask), edit_gt=jnp.asarray(gt))
    got = tgd.p_mean_variance(tt, torch.as_tensor(out), torch.as_tensor(x),
                              torch.as_tensor(t),
                              mean_type=getattr(tgd.ModelMeanType, mean_type),
                              edit_mask=torch.as_tensor(mask),
                              edit_gt=torch.as_tensor(gt))
    for name in ("mean", "pred_xstart", "eps"):
        np.testing.assert_allclose(getattr(got, name).numpy(),
                                   np.asarray(getattr(ref, name)),
                                   rtol=1e-5, atol=1e-5, err_msg=name)
    np.testing.assert_array_equal(got.pred_xstart[:, :, :8].numpy(), gt[:, :, :8])


def _edit_chain_both(fx, jcfg, tcfg, steps, seed, gt_roll, l_start, l_end):
    jdit = JaxDiT["DiTRotary_XS_8"](input_size=(128, 16), in_channels=4,
                                   num_classes=0)
    jvae = JaxVAE(**TINY_VAE)
    jt = jschedule.make_schedule("linear", 1000, str(steps)).tables()
    decode = jmake_decode(lambda z: jvae.apply(fx["vae"], z, method=JaxVAE.decode),
                          fx["scale"])
    encode = jmake_encode(lambda x: jvae.apply(fx["vae"], x,
                                               method=JaxVAE.encode_moments),
                          fx["scale"])
    rules_src = make_rolls(3, seed=21)[1:, ..., l_start * 8:l_end * 8]
    jrules = {n: JFUNC[n](jnp.asarray(rules_src)) for n, _ in WEIGHTS}
    with jax.default_matmul_precision("highest"):
        jgt = encode(jnp.asarray(gt_roll))
        jmask = jnp.ones_like(jgt).at[:, :, l_start:l_end, :].set(0.0)
        jx, jrec = jax.jit(lambda key: jsampling.sample_loop(
            key, lambda x, t, y=None: jdit.apply(fx["dit"], x, t), jgt.shape, jt,
            jcfg, rules=jrules, decode_fn=decode, edit_gt=jgt,
            edit_mask=jmask))(jax.random.PRNGKey(seed))

    tdit = pipeline.create_denoiser("DiTRotary_XS_8", num_classes=0,
                                    model_path=FIXTURE, dtype=torch.float32,
                                    device="cpu")
    tvae = _tiny_vae()
    tt = tschedule.make_schedule("linear", 1000, str(steps)).tables("cpu")
    tgt = pipeline.encode_rolls(tvae, torch.as_tensor(gt_roll), fx["scale"])
    tmask = torch.ones_like(tgt)
    tmask[:, :, l_start:l_end, :] = 0.0
    trules = pipeline.extract_targets_from_rolls([n for n, _ in WEIGHTS],
                                                 torch.as_tensor(rules_src))
    tx, trec = pipeline.generate(
        tdit, tvae, tt, tcfg, tuple(tgt.shape), trules,
        noise_fn=jax_replay_noise(seed, tcfg.edit.noise_level), num_classes=0,
        scale_factor=fx["scale"], edit_gt=tgt, edit_mask=tmask)
    return np.asarray(jx), jrec, np.asarray(jgt), tx.numpy(), trec, tgt.numpy()


def test_edit_scg_chain_matches_jax(fx):
    """An 8-step DDPM chain cut to start at noise_level 6, SCG k=4 on the
    editable slice [32, 64): the same candidate at every guided step, the
    final latents within 1e-3 (as the SCG chain test), and the pinned
    region kept at the encoded gt to 1e-4, as
    test_quality_regression.py holds the JAX chain."""
    steps, nl, l_start, l_end, seed = 8, 6, 32, 64, 4
    gt_roll = make_rolls(2, seed=11)
    kw = dict(guidance=dict(schedule=True, t_start=750),
              scg=dict(num_samples=4, weights=WEIGHTS),
              edit=dict(noise_level=nl, l_start=l_start, l_end=l_end), record=True)
    jcfg = jsampling.SamplerConfig(
        guidance=jsampling.GuidanceConfig(**kw["guidance"]),
        scg=jsampling.SCGConfig(**kw["scg"]),
        edit=jsampling.EditConfig(**kw["edit"]), record=True)
    tcfg = tconfig.SamplerConfig(
        guidance=tconfig.GuidanceConfig(**kw["guidance"]),
        scg=tconfig.SCGConfig(**kw["scg"]),
        edit=tconfig.EditConfig(**kw["edit"]), record=True)
    jx, jrec, jgt, tx, trec, tgt = _edit_chain_both(fx, jcfg, tcfg, steps, seed,
                                                    gt_roll, l_start, l_end)
    encoded_close(tgt, jgt)
    jsel = np.asarray(jrec["candidate_log_prob"]).argmax(axis=1)
    tsel = trec["candidate_log_prob"].numpy().argmax(axis=1)
    assert (trec["selected"].numpy() >= 0).sum() == (nl - 1) * 2
    np.testing.assert_array_equal(tsel, jsel)
    np.testing.assert_allclose(tx, jx, rtol=0, atol=1e-3)
    pinned = np.ones(tx.shape[2], bool)
    pinned[l_start:l_end] = False
    np.testing.assert_allclose(tx[:, :, pinned], tgt[:, :, pinned], atol=1e-4)
    assert np.abs(tx[:, :, ~pinned] - tgt[:, :, ~pinned]).mean() > 0.05


def test_edit_noise_level_outside_the_chain_raises():
    tables = tschedule.make_schedule("linear", 1000, "10").tables("cpu")
    config = tconfig.SamplerConfig(edit=tconfig.EditConfig(noise_level=500))
    shape = (1, 4, 16, 16)
    with pytest.raises(ValueError, match="noise_level 500"):
        tsampling.sample_loop(lambda x, t, y: torch.zeros_like(x), shape, tables,
                              config, noise_fn=tsampling.torch_noise_fn(None, "cpu"),
                              edit_gt=torch.zeros(shape), edit_mask=torch.ones(shape))


@pytest.mark.parametrize("sampler", ["dpmpp", "ddim"])
def test_edit_composes_with_other_samplers_and_reuse(fx, sampler):
    """DPM-Solver++ (2M) and DDIM with reuse 2 on an edit chain, as the JAX
    package's test_dpmpp_edit_chain_runs and
    test_reuse_first_step_refreshes_on_edit_chain run them: the same final
    latents as the JAX chain with its noise replayed."""
    steps, nl = 8, 5
    shape = (1, 4, 32, 16)
    gt = np.ones(shape, np.float32) * 2.0
    mask = np.zeros(shape, np.float32)
    mask[:, :, :8] = 1.0
    fields = dict(sampler=sampler) if sampler == "dpmpp" else dict(
        sampler=sampler, reuse_interval=2)
    jcfg = jsampling.SamplerConfig(**fields, edit=jsampling.EditConfig(
        noise_level=nl, l_start=8, l_end=32))
    tcfg = tconfig.SamplerConfig(**fields, edit=tconfig.EditConfig(
        noise_level=nl, l_start=8, l_end=32))
    jdit = JaxDiT["DiTRotary_XS_8"](input_size=(32, 16), in_channels=4,
                                   num_classes=0)
    tdit = pipeline.create_denoiser("DiTRotary_XS_8", input_size=(32, 16),
                                    num_classes=0, model_path=FIXTURE,
                                    dtype=torch.float32, device="cpu")
    jt = jschedule.make_schedule("linear", 1000, str(steps)).tables()
    tt = tschedule.make_schedule("linear", 1000, str(steps)).tables("cpu")
    with jax.default_matmul_precision("highest"):
        jx, _ = jsampling.sample_loop(
            jax.random.PRNGKey(2), lambda x, t, y=None: jdit.apply(fx["dit"], x, t),
            shape, jt, jcfg, edit_gt=jnp.asarray(gt), edit_mask=jnp.asarray(mask))
    with torch.no_grad():
        tx, _ = tsampling.sample_loop(
            lambda x, t, y=None: tdit(x, t, None),
            shape, tt, tcfg, noise_fn=jax_replay_noise(2, nl),
            edit_gt=torch.as_tensor(gt), edit_mask=torch.as_tensor(mask))
    np.testing.assert_allclose(tx.numpy(), np.asarray(jx), rtol=0, atol=1e-3)
    np.testing.assert_allclose(tx.numpy()[:, :, :8], 2.0, atol=0.2)


def test_ddim_reverse_loop_matches_jax(fx):
    shape = (2, 4, 128, 16)
    x0 = np.random.default_rng(8).standard_normal(shape).astype(np.float32)
    jdit = JaxDiT["DiTRotary_XS_8"](input_size=(128, 16), in_channels=4,
                                   num_classes=0)
    tdit = pipeline.create_denoiser("DiTRotary_XS_8", num_classes=0,
                                    model_path=FIXTURE, dtype=torch.float32,
                                    device="cpu")
    jt = jschedule.make_schedule("linear", 1000, "ddim10").tables()
    tt = tschedule.make_schedule("linear", 1000, "ddim10").tables("cpu")
    for t_stop in (None, 4):
        with jax.default_matmul_precision("highest"):
            ref = np.asarray(jsampling.ddim_reverse_loop(
                jax.random.PRNGKey(0), lambda x, t, y=None: jdit.apply(fx["dit"], x, t),
                jnp.asarray(x0), jt, t_stop=t_stop))
        with torch.no_grad():
            out = tsampling.ddim_reverse_loop(
                lambda x, t, y=None: tdit(x, t, None), torch.as_tensor(x0), tt,
                t_stop=t_stop)
        np.testing.assert_allclose(out.numpy(), ref, rtol=1e-4, atol=1e-4)


def _ns(target_rules):
    return types.SimpleNamespace(target_rules=types.SimpleNamespace(**target_rules))


@pytest.mark.parametrize("case", ["given", "null_hr2", "int_shift", "bins_file",
                                  "chord_null"])
def test_resolve_edit_targets_matches_jax(tmp_path, case):
    """Given targets (nd_scg_given_target.yml), null ones with the random
    class shift (nd_500_num16.yml), an int shift, a bins file, and a rule
    measured on the source (chord.yml)."""
    gt = make_rolls(3, seed=13)[..., 256:512]
    bins = ""
    if case == "given":
        cfg = tconfig.load_config(os.path.join(EDIT_YAMLS, "nd_scg_given_target.yml"))
    elif case == "null_hr2":
        cfg = tconfig.load_config(os.path.join(EDIT_YAMLS, "nd_500_num16.yml"))
    elif case == "chord_null":
        cfg = tconfig.load_config(os.path.join(EDIT_YAMLS, "chord.yml"))
    else:
        cfg = _ns({"vertical_nd": 2 if case == "int_shift" else None,
                   "horizontal_nd": None, "pitch_hist": [1.0] * 6 + [3.0] * 6})
    if case == "bins_file":
        bins = str(tmp_path / "bins.json")
        with open(bins, "w") as f:
            f.write('{"vertical_bounds": [1, 2, 3, 4, 5, 6, 7], '
                    '"horizontal_bounds": [0.5, 1, 1.5, 2, 2.5, 3, 3.5], '
                    '"vertical_centers": [0.5, 1.5, 2.5, 3.5, 4.5, 5.5, 6.5, 7.5], '
                    '"horizontal_centers": [0.2, 0.7, 1.2, 1.7, 2.2, 2.7, 3.2, 3.7]}')
    ref = jresolve_edit_targets(cfg, jnp.asarray(gt), 3, np.random.default_rng(5),
                                nd_bins_file=bins)
    got = edit.resolve_edit_targets(cfg, torch.as_tensor(gt), 3,
                                    np.random.default_rng(5), nd_bins_file=bins)
    assert set(got) == set(ref)
    for name in ref:
        np.testing.assert_allclose(got[name].numpy(), np.asarray(ref[name]),
                                   rtol=1e-6, atol=1e-6, err_msg=name)


def _write_test_set(tmp_path, n=3):
    """A manifest of uint8 rolls, ``<prefix>_test_cls_1.csv``."""
    rolls = make_rolls(n, length=1100, seed=31)
    paths = []
    for i, roll in enumerate(rolls):
        path = tmp_path / f"roll{i}.npy"
        np.save(path, np.round((roll + 1.0) * 63.5).astype(np.uint8))
        paths.append(str(path))
    with open(tmp_path / "data_test_cls_1.csv", "w", newline="") as f:
        writer = csv.writer(f)
        writer.writerow(["midi_filename", "classes"])
        writer.writerows([p, 1] for p in paths)
    return str(tmp_path / "data")


def _edit_yaml(tmp_path, source, noise_level=6):
    """nd_scg_given_target.yml with ``noise_level`` inside an 8-step chain
    and the given ``source``."""
    with open(os.path.join(EDIT_YAMLS, "nd_scg_given_target.yml")) as f:
        text = f.read()
    text = text.replace("noise_level: 500", f"noise_level: {noise_level}")
    text = text.replace("source: dataset", f"source: {source}")
    path = tmp_path / "edit.yml"
    path.write_text(text)
    return str(path)


@pytest.mark.parametrize("source", ["dataset", "midi"])
def test_edit_cli_writes_its_files(tmp_path, source):
    prefix = _write_test_set(tmp_path)
    src = "dataset"
    if source == "midi":
        from rule_guided_music_tpu_torch.data.pianoroll import (
            finalize_decoded_sample, roll_to_midi)
        from rule_guided_music_tpu_torch.data.midi_io import write_midi
        src = str(tmp_path / "source.mid")
        write_midi(src, roll_to_midi(finalize_decoded_sample(
            make_rolls(1, length=700, seed=2))[0].astype(np.float32)))
    out = tmp_path / "out"
    rows = edit.main([
        "--config_path", _edit_yaml(tmp_path, src), "--data_dir", prefix,
        "--model", "DiTRotary_XS_8", "--num_classes", "0",
        "--model_path", FIXTURE, "--vae_path", FIXTURE, "--vae_arch", TINY_VAE_ARCH,
        "--batch_size", "2", "--num_samples", "2", "--timestep_respacing", "8",
        "--device", "cpu", "--dtype", "float32", "--out_dir", str(out)])
    assert len(rows) == 2 and "note_density.loss" in rows[0]
    names = sorted(os.listdir(out))
    assert names == ["gt", "results.csv", "sample_0_y_1.midi",
                     "sample_1_y_1.midi", "summary.csv"]
    assert sorted(os.listdir(out / "gt")) == ["sample_0_y_1.midi", "sample_1_y_1.midi"]
    assert len(read_midi(str(out / "gt" / "sample_0_y_1.midi")).notes) > 0
    with open(out / "summary.csv") as f:
        assert next(csv.reader(f)) == ["", "Attr", "Mean", "Std"]
    # the targets are the YAML's (3, 3 | 10/5, 10/5) on the slice's 2 windows
    with open(out / "results.csv") as f:
        row = next(csv.DictReader(f))
    assert row["note_density.target_rule"] == "[3.0, 3.0, 2.0, 2.0]"


def test_diagonal_gaussian_matches_jax():
    """The posterior of the encoder's moments: mean, the clamped
    log-variance, mode, KL and NLL as the JAX package computes them."""
    from rule_guided_music_tpu.models.vae import DiagonalGaussian as JaxGaussian
    from rule_guided_music_tpu_torch.models.vae import DiagonalGaussian

    rng = np.random.default_rng(6)
    moments = rng.standard_normal((2, 8, 4, 4)).astype(np.float32) * 3
    moments[0, 4:, 0, 0] = [-40.0, 25.0, 0.0, 1.0]     # both clamps
    sample = rng.standard_normal((2, 4, 4, 4)).astype(np.float32)
    ref = JaxGaussian(jnp.asarray(moments), axis=1)
    got = DiagonalGaussian(torch.as_tensor(moments), dim=1)
    for name in ("mean", "logvar", "std", "var"):
        np.testing.assert_allclose(getattr(got, name).numpy(),
                                   np.asarray(getattr(ref, name)), rtol=1e-6)
    np.testing.assert_array_equal(got.mode().numpy(), np.asarray(ref.mode()))
    np.testing.assert_allclose(got.kl().numpy(), np.asarray(ref.kl()), rtol=1e-5)
    np.testing.assert_allclose(got.nll(torch.as_tensor(sample)).numpy(),
                               np.asarray(ref.nll(jnp.asarray(sample))), rtol=1e-5)
    draw = got.sample(torch.Generator().manual_seed(0))
    assert draw.shape == (2, 4, 4, 4) and torch.isfinite(draw).all()
