"""The port's TrainLoop and both training CLIs on the CPU at fixture size:
checkpoints (save, prune, restore, resume bit for bit), the loop's
batches, labels and logs, the eval hooks, and ``train_dit`` /
``train_vae`` end to end with the JAX scripts' flags."""

import importlib.util
import os

import numpy as np
import pytest
import torch

from rule_guided_music_tpu.utils.fixtures import make_rolls
from rule_guided_music_tpu_torch import pipeline, train_dit, train_vae
from rule_guided_music_tpu_torch.diffusion import schedule as tschedule
from rule_guided_music_tpu_torch.models.dit import DiT_models, init_weights_
from rule_guided_music_tpu_torch.training import train_loop as ttl
from rule_guided_music_tpu_torch.utils import logger

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURE = os.path.join(REPO, "tests", "fixtures", "quality_tiny.npz")
TINY_VAE_ARCH = '{"ch": 32, "ch_mult": [1, 1, 2, 2], "num_res_blocks": 1}'


@pytest.fixture(autouse=True)
def _fresh_logger():
    yield
    if logger.Logger.CURRENT is not None:
        logger.Logger.CURRENT.close()
    logger.Logger.CURRENT = None


def _latent_data(seed=0, b=2):
    rng = np.random.default_rng(seed)
    while True:
        yield (rng.standard_normal((b, 4, 128, 16)).astype(np.float32),
               {"y": rng.integers(0, 3, size=b)})


def _loop(tmp_path, **cfg):
    torch.manual_seed(0)
    model = init_weights_(DiT_models["DiTRotary_XS_8"](num_classes=3),
                          torch.Generator().manual_seed(1))
    with torch.no_grad():                 # make every block a function
        for p in model.parameters():
            p.add_(0.02 * torch.randn(p.shape, generator=torch.Generator().manual_seed(
                p.numel())))
    config = ttl.TrainConfig(lr=1e-3, ema_rate=0.9, log_interval=1, **cfg)
    return ttl.TrainLoop(model=model,
                         tables=tschedule.make_schedule("linear", 1000).tables("cpu"),
                         data=_latent_data(), config=config,
                         checkpoint_dir=str(tmp_path / "ckpt"), seed=3)


def _params(loop):
    return {k: v.detach().clone() for k, v in loop.model.state_dict().items()}


def test_save_prune_restore_resume(tmp_path):
    """save_interval 1, keep 2: after 4 steps only step_000002 and
    step_000003 stay, each with its SCHEMA; two fresh loops restored from
    step_000002 take one more step with the same inputs to bit-equal
    parameters, EMA and optimizer state; a wrong schema is refused."""
    logger.configure(dir=str(tmp_path / "run"), format_strs=["log"])
    a = _loop(tmp_path, save_interval=1, keep_checkpoints=2)
    a.run_loop(max_steps=4)
    ckpts = sorted(os.listdir(tmp_path / "ckpt"))
    assert ckpts == ["step_000002", "step_000003"], ckpts
    assert open(tmp_path / "ckpt" / "step_000002" / "SCHEMA").read().strip() == \
        ttl.TrainLoop.CKPT_SCHEMA
    assert ttl.TrainLoop.latest_checkpoint(str(tmp_path / "ckpt")).endswith("step_000003")
    assert "pruned old checkpoint step_000001" in (tmp_path / "run" / "log.txt").read_text()

    # the uninterrupted run, and the resumed one, from step 2's state
    b = _loop(tmp_path / "b", save_interval=10**6)
    b.restore(str(tmp_path / "ckpt" / "step_000002"))
    # as in JAX, step_NNNNNN is saved after the step of that index ran: it
    # holds NNNNNN + 1 steps, and resume_step is read from the name
    assert b.resume_step == 2 and b.state.step == 3 and b.state.updates == 3
    c = _loop(tmp_path / "c", save_interval=10**6)
    c.restore(str(tmp_path / "ckpt" / "step_000002"))
    rng = np.random.default_rng(9)
    lat = torch.as_tensor(rng.standard_normal((2, 4, 128, 16)).astype(np.float32))
    t, w = torch.tensor([10, 900]), torch.tensor([1.0, 0.5])
    y, drop = torch.tensor([0, 2]), torch.tensor([False, True])
    noise = torch.as_tensor(rng.standard_normal(lat.shape).astype(np.float32))
    for loop in (b, c):
        loop.step_fn(loop.state, lat, t, w, y, noise, drop)
    for k, v in b.model.state_dict().items():
        assert torch.equal(v, c.model.state_dict()[k]), k
        assert torch.equal(b.state.ema_params[k], c.state.ema_params[k]), k
    sb, sc = b.state.optimizer.state_dict(), c.state.optimizer.state_dict()
    for i in sb["state"]:
        for key in ("exp_avg", "exp_avg_sq"):
            assert torch.equal(sb["state"][i][key], sc["state"][i][key])
    d = _loop(tmp_path / "d", save_interval=10**6)
    d.restore(str(tmp_path / "ckpt" / "step_000003"))
    assert d.resume_step == 3
    with open(tmp_path / "ckpt" / "step_000003" / "SCHEMA", "w") as f:
        f.write("other/v0\n")
    with pytest.raises(ValueError, match="schema"):
        d.restore(str(tmp_path / "ckpt" / "step_000003"))


def test_latest_checkpoint_passes_over_an_unfinished_save(tmp_path):
    """A save writes state.pt whole (through a temporary file) and leaves
    no temporary file; a newer step directory whose save a kill cut short
    (a truncated state.pt.tmp, no state.pt) is passed over on resume."""
    logger.configure(dir=str(tmp_path / "run"), format_strs=["log"])
    a = _loop(tmp_path, save_interval=1)
    a.run_loop(max_steps=2)
    assert sorted(os.listdir(tmp_path / "ckpt" / "step_000001")) == ["SCHEMA", "state.pt"]
    cut = tmp_path / "ckpt" / "step_000009"
    cut.mkdir()
    data = (tmp_path / "ckpt" / "step_000001" / "state.pt").read_bytes()
    (cut / "state.pt.tmp").write_bytes(data[:len(data) // 2])
    latest = ttl.TrainLoop.latest_checkpoint(str(tmp_path / "ckpt"))
    assert latest.endswith("step_000001")
    b = _loop(tmp_path / "b", save_interval=10**6)
    b.restore(latest)
    assert b.resume_step == 1


def test_resumed_run_continues_the_uninterrupted_one(tmp_path):
    """Three steps straight, and two steps + save + restore + one step of
    a fresh loop fed the batches the third step would see: equal to the
    bit (the loop's own draws are replaced by the same explicit ones)."""
    logger.configure(dir=str(tmp_path / "run"), format_strs=[])
    inputs = []
    rng = np.random.default_rng(4)
    for _ in range(3):
        lat = torch.as_tensor(rng.standard_normal((2, 4, 128, 16)).astype(np.float32))
        inputs.append((lat, torch.as_tensor(rng.integers(0, 1000, 2)),
                       torch.ones(2), torch.tensor([1, 2]),
                       torch.as_tensor(rng.standard_normal(lat.shape).astype(np.float32)),
                       torch.tensor([True, False])))
    straight = _loop(tmp_path / "s")
    for args in inputs:
        straight.step_fn(straight.state, *args)
    first = _loop(tmp_path / "f")
    for args in inputs[:2]:
        first.step_fn(first.state, *args)
    first.step = 2
    first.save()
    resumed = _loop(tmp_path / "r")
    resumed.restore(str(tmp_path / "f" / "ckpt" / "step_000002"))
    resumed.step_fn(resumed.state, *inputs[2])
    for k, v in straight.model.state_dict().items():
        assert torch.equal(v, resumed.model.state_dict()[k]), k
        assert torch.equal(straight.state.ema_params[k], resumed.state.ema_params[k])


def test_loop_batches_labels_and_logs(tmp_path):
    """With a VAE: rolls of 1536 columns become 2 windows each, labels are
    repeated to match, every step logs the quartile keys, grad_norm and
    param_norm, and the eval-loss hook logs eval_* keys under the EMA."""
    logger.configure(dir=str(tmp_path / "run"), format_strs=["csv"])
    vae = pipeline.create_vae(FIXTURE, arch=dict(ch=32, ch_mult=(1, 1, 2, 2),
                                                 num_res_blocks=1),
                              encoder=True, dtype=torch.float32, device="cpu")

    def rolls(seed):
        while True:
            yield make_rolls(2, length=1536, seed=seed), {"y": np.array([0, 2])}

    loop = _loop(tmp_path, eval_interval=1)
    loop.data, loop.eval_data = rolls(1), rolls(2)
    loop.vae_encode = vae.encode_moments
    loop.eval_loss_fn = ttl.make_eval_loss_step(loop.model, loop.tables, loop.config)
    latents, t_np, t, w_np, w, y = loop._prepare_batch(*next(rolls(1)))
    assert latents.shape == (4, 4, 128, 16) and y.tolist() == [0, 0, 2, 2]
    assert t.shape == (4,) and np.all(w_np == 1.0)
    loop.run_loop(max_steps=2)
    header = (tmp_path / "run" / "progress.csv").read_text().splitlines()[0].split(",")
    for key in ("loss", "mse", "grad_norm", "param_norm", "step", "eval_loss",
                "eval_mse"):
        assert key in header, header
    assert any(k.startswith("loss_q") for k in header)
    assert len(loop.step_ms) == 2


def test_eval_sampling_fn_writes_midi(tmp_path):
    """The sampling hook: EMA parameters, DDIM on the port's sampler, the
    fixture's decoder, class-balanced labels, MIDI under samples/iter_<step>."""
    logger.configure(dir=str(tmp_path / "run"), format_strs=[])
    loop = _loop(tmp_path)
    vae = pipeline.create_vae(FIXTURE, arch=dict(ch=32, ch_mult=(1, 1, 2, 2),
                                                 num_res_blocks=1),
                              dtype=torch.float32, device="cpu")
    tables = tschedule.make_schedule("linear", 1000, "ddim4").tables("cpu")
    fn = ttl.make_eval_sampling_fn(loop.model, tables, vae=vae, sample_batch_size=3,
                                   num_classes=3, scale_factor=1.0)
    fn(loop)
    out = sorted(os.listdir(tmp_path / "run" / "samples" / "iter_0"))
    assert out == ["sample_0_y_0.midi", "sample_1_y_1.midi", "sample_2_y_2.midi"]


def test_optimizer_refusals_and_anneal_end(tmp_path):
    with pytest.raises(ValueError, match="unknown optimizer"):
        ttl.make_optimizer(ttl.TrainConfig(optimizer="lamb"), [])
    logger.configure(dir=str(tmp_path / "run"), format_strs=[])
    loop = _loop(tmp_path, lr_anneal_steps=2)
    loop.run_loop(max_steps=10)                   # stops at the anneal's end
    assert loop.step == 2 and loop.state.updates == 2
    assert os.listdir(tmp_path / "ckpt") == ["step_000002"]


def _write_manifest(tmp_path, n=4, length=1100):
    import csv

    rows = []
    for i, roll in enumerate(make_rolls(n, length=length, seed=31)):
        path = str(tmp_path / f"roll{i}.npy")
        np.save(path, np.round((roll + 1.0) * 63.5).astype(np.uint8))
        rows.append([path, i % 3])
    with open(tmp_path / "train.csv", "w", newline="") as f:
        writer = csv.writer(f)
        writer.writerow(["midi_filename", "classes"])
        writer.writerows(rows)
    return str(tmp_path / "train.csv")


DIT_FLAGS = ["--model", "DiTRotary_XS_8", "--vae_path", FIXTURE, "--vae_arch",
             TINY_VAE_ARCH, "--pr_image_size", "1024", "--batch_size", "2",
             "--encode_rep", "1", "--log_interval", "1", "--device", "cpu"]


def test_train_dit_cli_runs_and_resumes(tmp_path, monkeypatch):
    """Two steps at fixture size with --bf16 False, then --resume True for
    two more: log.txt, progress.csv, checkpoints step_000002 then
    step_000004 (the final save is named by the resumed count, as in
    JAX)."""
    monkeypatch.chdir(tmp_path)
    data = _write_manifest(tmp_path)
    loop = train_dit.main(["--data_dir", data, "--dir", "dit", "--max_steps", "2",
                           "--bf16", "False", *DIT_FLAGS])
    run = tmp_path / "loggings" / "dit"
    assert (run / "log.txt").exists() and (run / "progress.csv").exists()
    assert os.listdir(run / "checkpoints") == ["step_000002"]
    assert all(p.dtype == torch.float32 for p in loop.model.parameters())
    assert "grad_norm" in (run / "progress.csv").read_text().splitlines()[0]
    again = train_dit.main(["--data_dir", data, "--dir", "dit", "--max_steps", "2",
                            "--bf16", "False", "--resume", "True", *DIT_FLAGS])
    assert again.resume_step == 2
    assert sorted(os.listdir(run / "checkpoints")) == ["step_000002", "step_000004"]


def test_train_dit_cli_bf16_with_trace(tmp_path, monkeypatch):
    """The default bf16 compute, profile_step 1 (a torch.profiler trace of
    that step), labels repeated by encode_rep."""
    monkeypatch.chdir(tmp_path)
    data = _write_manifest(tmp_path, length=1600)
    flags = [f for f in DIT_FLAGS]
    flags[flags.index("--pr_image_size") + 1] = "1536"
    flags[flags.index("--batch_size") + 1] = "4"
    flags[flags.index("--encode_rep") + 1] = "2"
    loop = train_dit.main(["--data_dir", data, "--dir", "b", "--max_steps", "2",
                           "--profile_step", "1", *flags])
    assert loop.trace is not None and os.path.exists(loop.trace.path)
    assert loop.state.updates == 2


def test_train_dit_refusals(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            train_dit.main(["--data_dir", "unused.csv"])
        with pytest.raises(RuntimeError, match="CUDA"):
            train_vae.main(["--chunk_dir", "unused"])
    with pytest.raises(ValueError, match="cannot factor 1 device"):
        train_dit.main(["--data_dir", "unused.csv", "--device", "cpu", "--dp", "2"])
    data = _write_manifest(tmp_path)
    with pytest.raises(ValueError, match="unknown optimizer"):
        train_dit.main(["--data_dir", data, "--optimizer", "lamb",
                        "--max_steps", "1", *DIT_FLAGS])


def _jax_script(name):
    spec = importlib.util.spec_from_file_location(
        f"jax_{name}", os.path.join(REPO, "scripts", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_train_dit_flags_and_defaults_match_the_jax_script():
    want = vars(_jax_script("train_dit").create_argparser().parse_args([]))
    got = vars(train_dit.create_argparser().parse_args([]))
    assert got.pop("device") == "cuda"
    assert got == want


def test_train_vae_cli_runs(tmp_path, monkeypatch):
    """Two steps of one chunk (the script builds the production VAE; it
    has no geometry flag) with the patch-GAN and LPIPS on (random LPIPS
    weights, with the warning), a save at step 1."""
    monkeypatch.chdir(tmp_path)
    os.makedirs("chunks")
    for i, roll in enumerate(make_rolls(4, length=128, seed=2)):
        np.save(f"chunks/c{i}.npy", np.round((roll + 1.0) * 63.5).astype(np.uint8))
    vae, history = train_vae.main(["--chunk_dir", "chunks", "--batch_size", "1",
                               "--iterations", "2", "--log_interval", "1",
                               "--save_interval", "1", "--device", "cpu",
                               "--dir", "vae", "--disc_weight", "0.5",
                               "--perceptual_weight", "0.1"])
    run = tmp_path / "loggings" / "vae"
    log = (run / "log.txt").read_text()
    assert "random LPIPS weights" in log
    header = (run / "progress.csv").read_text().splitlines()[0].split(",")
    assert {"aeloss", "rec_loss", "kl_loss", "g_loss", "step"} <= set(header)
    assert os.listdir(run / "checkpoints") == ["vae000001"]
    saved = torch.load(run / "checkpoints" / "vae000001" / "state.pt")
    assert set(saved) == set(vae.state_dict())
    assert len(history) == 2
    assert all(np.isfinite(v) for h in history for v in h.values())


def test_chunk_batches_match_the_jax_script(tmp_path):
    """The same files, the same shuffles and the same normalization."""
    import jax.numpy as jnp  # noqa: F401  (the JAX script yields jnp arrays)

    for i, roll in enumerate(make_rolls(6, length=128, seed=3)):
        np.save(tmp_path / f"c{i}.npy", np.round((roll + 1.0) * 63.5).astype(np.uint8))
    jgen = _jax_script("train_vae").chunk_batches(str(tmp_path), 2, seed=5)
    tgen = train_vae.chunk_batches(str(tmp_path), 2, seed=5)
    for _ in range(5):
        np.testing.assert_array_equal(next(tgen), np.asarray(next(jgen)))
