"""Classifier training in the port against the JAX package (CPU, fp32).

``DiTClassifier`` and ``EncoderUNetModel`` on JAX's weights (each leaf
moved by seeded noise, converted by ``convert.py``), the loader's rule
labels, sharding and prefetch against JAX's ``load_data``, the copied
composer clusters, the classifier step's loss and gradients against a
JAX step built from the JAX package's parts with the same t and noise,
and the ``classifier_train_aug`` CLI. Tolerances: models 1e-4 relative and
absolute (the other model parity tests' fp32 allowance); float rule labels
1e-5 relative, 1e-6 absolute (tests/test_torch_rules.py); chord tags equal
except in windows whose best triads tie exactly; the loss within 1e-5
relative and each gradient within 1e-4 of its tensor's largest.
"""

import csv
import importlib.util
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from rule_guided_music_tpu.data import composer_clusters as jclusters
from rule_guided_music_tpu.data import datasets as jdatasets
from rule_guided_music_tpu.diffusion import gaussian as jgd
from rule_guided_music_tpu.diffusion.schedule import make_schedule as jmake_schedule
from rule_guided_music_tpu.models import DiT_models as JaxDiT
from rule_guided_music_tpu.models.dit import DiTRotaryClassifier as JaxRotCls
from rule_guided_music_tpu.models.unet import EncoderUNetModel as JaxEncoderUNet
from rule_guided_music_tpu.utils.fixtures import flatten_tree, make_rolls, unflatten_tree
from rule_guided_music_tpu_torch import classifier_train_aug as cta
from rule_guided_music_tpu_torch import convert, pipeline
from rule_guided_music_tpu_torch.data import composer_clusters as tclusters
from rule_guided_music_tpu_torch.data import datasets as tdatasets
from rule_guided_music_tpu_torch.diffusion.schedule import make_schedule
from rule_guided_music_tpu_torch.models.dit import DiT_models, DiTRotaryClassifier
from rule_guided_music_tpu_torch.models.unet import EncoderUNetModel
from rule_guided_music_tpu_torch.utils import logger

from test_torch_rules import _assert_tags_equal_up_to_exact_ties

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MODEL_TOL = dict(rtol=1e-4, atol=1e-4)


@pytest.fixture(autouse=True)
def _threads():
    """The suite runs several workers on one machine."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)
    if logger.Logger.CURRENT is not None:
        logger.Logger.CURRENT.close()
    logger.Logger.CURRENT = None


def noisy_params(model, args, seed, scale=0.05):
    """JAX's init moved by seeded noise: (flax params, flat numpy tree)."""
    params = jax.jit(model.init)(jax.random.PRNGKey(0), *args)
    flat = flatten_tree(jax.tree_util.tree_map(np.asarray, params))
    rng = np.random.default_rng(seed)
    flat = {k: (v + scale * rng.standard_normal(v.shape)).astype(np.float32)
            for k, v in flat.items()}
    return jax.tree_util.tree_map(jnp.asarray, unflatten_tree(flat)), flat


# -- models -------------------------------------------------------------------

CLS_NAMES = ["DiT-B/4-cls", "DiT-B/8-cls", "DiT-S/4-cls", "DiT-S/2-cls", "DiT-XS/2-cls"]


@pytest.mark.parametrize("name", CLS_NAMES)
def test_dit_classifier_parameter_counts_match_jax(name):
    """At the pixel trainer's geometry, (3, 128, 128) and 16 classes."""
    jmodel = JaxDiT[name](input_size=(128, 128), in_channels=3, num_classes=16)
    shapes = jax.eval_shape(jmodel.init, jax.random.PRNGKey(0),
                            jnp.zeros((1, 3, 128, 128)), jnp.zeros((1,)))
    want = sum(int(np.prod(s.shape)) for s in jax.tree_util.tree_leaves(shapes))
    with torch.device("meta"):
        model = DiT_models[name](input_size=(128, 128), in_channels=3, num_classes=16)
    assert sum(p.numel() for p in model.parameters()) == want


@pytest.mark.parametrize("patchify", [True, False])
def test_dit_classifier_matches_jax(patchify):
    """DiT-XS/2-cls on (3, 32, 16) (128 patches + CLS), and its one-token-a-
    row variant (32 rows + CLS)."""
    kw = dict(input_size=(32, 16), in_channels=3, num_classes=5, patchify=patchify)
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 3, 32, 16)).astype(np.float32)
    t = np.array([3.0, 611.0], np.float32)
    jmodel = JaxDiT["DiT-XS/2-cls"](**kw)
    params, flat = noisy_params(jmodel, (jnp.asarray(x), jnp.asarray(t)), seed=2)
    with jax.default_matmul_precision("highest"):
        ref = np.asarray(jax.jit(jmodel.apply)(params, jnp.asarray(x), jnp.asarray(t)))
    model = DiT_models["DiT-XS/2-cls"](**kw)
    model.load_state_dict(convert.classifier_state_dict(flat), strict=True)
    with torch.no_grad():
        out = model(torch.as_tensor(x), torch.as_tensor(t))
    assert out.dtype == torch.float32 and out.shape == (2, 5)
    np.testing.assert_allclose(out.numpy(), ref, **MODEL_TOL)


# JAX's tests/test_unet.py:53-77 geometries, and a mean-pool one
ENCODER_GEOMETRIES = {
    "attention": dict(in_channels=3, model_channels=8, out_channels=16,
                      num_res_blocks=1, attention_resolutions=(4,),
                      channel_mult=(1, 2, 2), num_heads=2, pool="attention"),
    "mean": dict(in_channels=3, model_channels=8, out_channels=16,
                 num_res_blocks=1, attention_resolutions=(2,), channel_mult=(1, 2, 2),
                 num_heads=2, num_head_channels=8, pool="mean",
                 resblock_updown=False, use_scale_shift_norm=False),
    "chord": dict(in_channels=3, model_channels=8, out_channels=8, num_res_blocks=1,
                  attention_resolutions=(), channel_mult=(1, 2), num_heads=2,
                  chord=True),
}


@pytest.mark.parametrize("geometry", sorted(ENCODER_GEOMETRIES))
def test_encoder_unet_matches_jax(geometry):
    kw = ENCODER_GEOMETRIES[geometry]
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 3, 32, 32)).astype(np.float32)
    t = np.array([3.0, 611.0], np.float32)
    jmodel = JaxEncoderUNet(**kw)
    params, flat = noisy_params(jmodel, (jnp.asarray(x), jnp.asarray(t)), seed=4)
    with jax.default_matmul_precision("highest"):
        ref = jax.jit(jmodel.apply)(params, jnp.asarray(x), jnp.asarray(t))
    model = EncoderUNetModel(**kw)
    model.load_state_dict(convert.encoder_unet_state_dict(flat), strict=True)
    with torch.no_grad():
        out = model(torch.as_tensor(x), torch.as_tensor(t))
    refs, outs = (ref, out) if isinstance(ref, tuple) else ((ref,), (out,))
    for o, r in zip(outs, refs):
        assert o.dtype == torch.float32 and o.shape == r.shape
        np.testing.assert_allclose(o.numpy(), np.asarray(r), **MODEL_TOL)
    if geometry == "chord":
        assert outs[0].shape == (2, 25) and outs[1].shape == (2, 16, 8)


def test_load_weights_reads_both_new_kinds(tmp_path):
    """``pipeline.load_weights`` with kind "cls" takes a DiTClassifier npz,
    and "encoder_unet" an EncoderUNetModel npz."""
    for kind, jmodel, model, args in (
            ("cls", JaxDiT["DiT-XS/2-cls"](input_size=(16, 16), in_channels=3,
                                           num_classes=4),
             DiT_models["DiT-XS/2-cls"](input_size=(16, 16), in_channels=3,
                                        num_classes=4), (2, 3, 16, 16)),
            ("encoder_unet", JaxEncoderUNet(**ENCODER_GEOMETRIES["chord"]),
             EncoderUNetModel(**ENCODER_GEOMETRIES["chord"]), (2, 3, 32, 32))):
        _, flat = noisy_params(jmodel, (jnp.zeros(args), jnp.zeros((2,))), seed=5)
        path = str(tmp_path / f"{kind}.npz")
        np.savez(path, **flat)
        pipeline.load_weights(model, path, kind)
        sd = model.state_dict()
        key = "cls_token" if kind == "cls" else "key_head.bias"
        np.testing.assert_array_equal(sd[key].numpy().ravel(),
                                      flat["params/" + key.replace(".", "/")].ravel())


# -- the loader -----------------------------------------------------------------

def write_manifest(tmp_path, n=6, length=1100, seed=31):
    rows = []
    for i, roll in enumerate(make_rolls(n, length=length, seed=seed)):
        path = str(tmp_path / f"roll{i}.npy")
        np.save(path, np.round((roll + 1.0) * 63.5).astype(np.uint8))
        rows.append([path, i % 3])
    with open(tmp_path / "train.csv", "w", newline="") as f:
        writer = csv.writer(f)
        writer.writerow(["midi_filename", "classes"])
        writer.writerows(rows)
    return str(tmp_path / "train.csv")


def _batches(mod, n, **kw):
    gen = mod.load_data(**kw)
    return [next(gen) for _ in range(n)]


@pytest.mark.parametrize("rule,image_size", [
    ("note_density", 1024), ("pitch_hist", 1024), ("chord_progression", 1024),
    ("note_density_pixel", 128), ("chord_progression_pixel", 128)])
def test_rule_labels_match_jax(tmp_path, rule, image_size):
    manifest = write_manifest(tmp_path)
    kw = dict(data_dir=manifest, batch_size=3, image_size=image_size, rule=rule,
              seed=4, class_cond=True)
    for (tx, tc), (jx, jc) in zip(_batches(tdatasets, 2, **kw),
                                  _batches(jdatasets, 2, **kw)):
        np.testing.assert_array_equal(tx, jx)
        assert set(tc) == set(jc)
        np.testing.assert_array_equal(tc["y"], jc["y"])
        if "chord" in rule:
            assert tc["chord"].dtype == np.int32 and tc["key"].dtype == np.int64
            np.testing.assert_array_equal(tc["key"], jc["key"])
            fs = 12.5 if "pixel" in rule else 100
            _assert_tags_equal_up_to_exact_ties(tx, tc["chord"], np.asarray(jc["chord"]),
                                                fs)
        else:
            assert tc[rule].shape == jc[rule].shape
            np.testing.assert_allclose(tc[rule], jc[rule], rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("shard,num_shards,prefetch", [
    (0, 1, 0), (0, 1, 2), (1, 2, 0), (1, 2, 2), (2, 3, 1)])
def test_shards_and_prefetch_match_jax(tmp_path, shard, num_shards, prefetch):
    manifest = write_manifest(tmp_path, n=7)
    kw = dict(data_dir=manifest, batch_size=2, image_size=1024, seed=9,
              class_cond=True, shard=shard, num_shards=num_shards)
    got = _batches(tdatasets, 3, prefetch=prefetch, **kw)
    want = _batches(jdatasets, 3, prefetch=0, **kw)
    for (tx, tc), (jx, jc) in zip(got, want):
        np.testing.assert_array_equal(tx, jx)
        np.testing.assert_array_equal(tc["y"], jc["y"])


def test_composer_clusters_match_jax(tmp_path):
    assert tclusters.CLUSTERS == jclusters.CLUSTERS
    assert tclusters.COMPOSER_TO_CLUSTER == jclusters.COMPOSER_TO_CLUSTER
    assert tclusters.NUM_COMPOSER_CLUSTERS == jclusters.NUM_COMPOSER_CLUSTERS == 9
    maestro = tmp_path / "maestro.csv"
    with open(maestro, "w", newline="") as f:
        writer = csv.writer(f)
        writer.writerow(["canonical_composer", "midi_filename"])
        for i, c in enumerate(["Frédéric Chopin", "Nobody", "Claude Debussy",
                               "Johann Sebastian Bach"]):
            writer.writerow([c, f"f{i}.midi"])
    got = tclusters.label_maestro_csv(str(maestro), str(tmp_path / "t.csv"))
    want = jclusters.label_maestro_csv(str(maestro), str(tmp_path / "j.csv"))
    assert got == want == (3, 1)
    assert (tmp_path / "t.csv").read_text() == (tmp_path / "j.csv").read_text()


# -- the classifier step --------------------------------------------------------

def _jax_loss_and_grads(jmodel, params, x0, t, labels, noise, rule):
    """JAX's loss_fn of scripts/classifier_train_aug.py, from the JAX
    package's parts, with the noise given."""
    tables = jmake_schedule("linear", 1000).tables()

    def loss_fn(p):
        x_t = jgd.q_sample(tables, x0, t, noise)
        out = jmodel.apply(p, x_t, tables.model_t[t])
        if "chord" in rule:
            key_logits, chord_logits = out
            key_loss = optax.softmax_cross_entropy_with_integer_labels(
                key_logits, labels["key"]).mean()
            chord_loss = optax.softmax_cross_entropy_with_integer_labels(
                chord_logits.reshape(-1, chord_logits.shape[-1]),
                labels["chord"].reshape(-1)).mean()
            return key_loss + chord_loss, {"key_loss": key_loss,
                                           "chord_loss": chord_loss}
        loss = ((out - labels[rule]) ** 2).sum(-1).mean()
        return loss, {"mse": loss}

    with jax.default_matmul_precision("highest"):
        (loss, aux), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(params)
    return float(loss), {k: float(v) for k, v in aux.items()}, grads


@pytest.mark.parametrize("rule", ["note_density", "chord_progression"])
def test_classifier_step_matches_jax(rule):
    """A 2-block rotary classifier (chord heads for the chord rule) on
    (4, 128, 16) latents: the same x0, t, labels and noise through JAX's
    loss and the port's ``classifier_loss``; then ``classifier_step``'s
    update moves every parameter."""
    chord = "chord" in rule
    kw = dict(depth=2, hidden_size=64, num_heads=2, num_classes=8 if chord else 16,
              chord=chord)
    rng = np.random.default_rng(6)
    x0 = rng.standard_normal((3, 4, 128, 16)).astype(np.float32)
    noise = rng.standard_normal(x0.shape).astype(np.float32)
    t = np.array([5, 480, 999], np.int32)
    if chord:
        labels = {"key": rng.integers(0, 25, 3), "chord": rng.integers(0, 8, (3, 8))}
    else:
        labels = {rule: rng.standard_normal((3, 16)).astype(np.float32)}
    jmodel = JaxRotCls(**kw)
    params, flat = noisy_params(jmodel, (jnp.asarray(x0), jnp.zeros((3,))), seed=7)
    jloss, jaux, jgrads = _jax_loss_and_grads(
        jmodel, params, jnp.asarray(x0), jnp.asarray(t),
        {k: jnp.asarray(v) for k, v in labels.items()}, jnp.asarray(noise), rule)
    model = DiTRotaryClassifier(**kw)
    model.load_state_dict(convert.classifier_state_dict(flat), strict=True)
    tables = make_schedule("linear", 1000).tables("cpu")
    tlabels = {k: torch.as_tensor(v) for k, v in labels.items()}
    loss, aux = cta.classifier_loss(model, tables, torch.as_tensor(x0),
                                    torch.as_tensor(t, dtype=torch.long), tlabels,
                                    torch.as_tensor(noise), rule)
    loss.backward()
    np.testing.assert_allclose(loss.item(), jloss, rtol=1e-5)
    for k, v in jaux.items():
        np.testing.assert_allclose(float(aux[k]), v, rtol=1e-5)
    if chord:
        assert set(aux) == {"key_loss", "chord_loss", "key_acc", "chord_acc"}
    want = convert.classifier_state_dict(
        flatten_tree(jax.tree_util.tree_map(np.asarray, jgrads)))
    for name, p in model.named_parameters():
        g, w = p.grad.numpy(), want[name].numpy()
        assert np.abs(g - w).max() <= 1e-4 * max(np.abs(w).max(), 1e-12), name
    before = {n: p.detach().clone() for n, p in model.named_parameters()}
    opt = torch.optim.AdamW(model.parameters(), lr=1e-3, weight_decay=0.05)
    cta.classifier_step(model, opt, tables, torch.as_tensor(x0),
                        torch.as_tensor(t, dtype=torch.long), tlabels,
                        torch.as_tensor(noise), rule)
    assert all(not torch.equal(before[n], p) for n, p in model.named_parameters())


# -- the CLI --------------------------------------------------------------------

def _jax_script(path):
    spec = importlib.util.spec_from_file_location("jax_cta", os.path.join(REPO, path))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_flags_and_defaults_match_the_jax_script():
    want = vars(_jax_script("scripts/classifier_train_aug.py")
                .create_argparser().parse_args([]))
    got = vars(cta.create_argparser().parse_args([]))
    assert got.pop("device") == "cuda"
    assert got == want


def test_cli_trains_saves_and_loads_back(tmp_path, monkeypatch):
    """Three iterations of DiTRotary-XS/8-cls on note_density through the
    production VAE encoder (random weights): JAX's log keys, a save at
    step 2 that ``load_weights(..., "cls")`` reads into
    ``build_classifier_bundles``."""
    monkeypatch.chdir(tmp_path)
    manifest = write_manifest(tmp_path, n=3)
    model, history = cta.main([
        "--data_dir", manifest, "--classifier_name", "DiTRotary-XS/8-cls",
        "--batch_size", "1", "--iterations", "3", "--save_interval", "2",
        "--log_interval", "1", "--bf16", "False", "--device", "cpu", "--dir", "cls"])
    assert len(history["loss"]) == 3 and np.isfinite(history["loss"]).all()
    run = tmp_path / "loggings" / "cls"
    header = (run / "progress.csv").read_text().splitlines()[0].split(",")
    assert {"loss", "mse", "step"} <= set(header)
    assert os.listdir(run / "checkpoints") == ["model000002.pt"]
    config = type("C", (), dict(names=["DiTRotary-XS/8-cls"], num_classes=[16],
                                paths=[str(run / "checkpoints" / "model000002.pt")]))
    (bundle,) = pipeline.build_classifier_bundles(config, dtype=torch.float32,
                                                  device="cpu")
    saved = torch.load(config.paths[0], weights_only=True)
    for name, p in bundle.state_dict().items():
        assert torch.equal(p, saved[name]), name


def test_cli_refuses_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("this checks the no-card refusal")
    with pytest.raises(RuntimeError, match="CUDA"):
        cta.main(["--data_dir", "unused.csv"])
