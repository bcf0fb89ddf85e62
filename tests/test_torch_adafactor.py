"""The port's Adafactor against ``optax.adafactor`` (the JAX package's
``--optimizer adafactor``), its state through a checkpoint, and
``train_dit --optimizer adafactor`` on the fixtures."""

import csv
import os

import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from rule_guided_music_tpu.utils.fixtures import make_rolls
from rule_guided_music_tpu_torch import train_dit
from rule_guided_music_tpu_torch.diffusion import schedule as tschedule
from rule_guided_music_tpu_torch.models.dit import DiT_models, init_weights_
from rule_guided_music_tpu_torch.training import adafactor as taf
from rule_guided_music_tpu_torch.training import train_loop as ttl
from rule_guided_music_tpu_torch.utils import logger

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURE = os.path.join(REPO, "tests", "fixtures", "quality_tiny.npz")
TINY_VAE_ARCH = '{"ch": 32, "ch_mult": [1, 1, 2, 2], "num_res_blocks": 1}'


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


# flax layout -> torch layout of each leaf: a Linear kernel (in, out) is
# transposed, a conv kernel (kh, kw, in, out) becomes (out, in, kh, kw)
TO_TORCH = {2: lambda a: a.T, 4: lambda a: np.transpose(a, (3, 2, 0, 1)),
            1: lambda a: a}
# flax shapes: a factored Linear (in < out), a square factored Linear (the
# two dims tie), a factored conv, an unfactored conv, a bias
SHAPES = {"dense": (136, 200), "square": (128, 128), "conv": (3, 3, 128, 130),
          "small_conv": (3, 3, 8, 16), "bias": (200,)}


def _tree(seed):
    rng = np.random.default_rng(seed)
    return {k: rng.standard_normal(s).astype(np.float32) * 0.1
            for k, s in SHAPES.items()}


def _from_torch(a):
    """A torch-layout array in flax's layout."""
    return {4: lambda a: np.transpose(a, (2, 3, 1, 0)), 2: lambda a: a.T,
            1: lambda a: a}[a.ndim](a)


def _torch_state_as_flax(name, st):
    """The port's state of one leaf in optax's layout: (v_row, v_col) or v.
    Where optax's two factored dims tie, its rows are the port's columns."""
    if "v" in st:
        return {"v": _from_torch(st["v"].numpy())}
    row, col = st["v_row"].numpy(), st["v_col"].numpy()
    if name == "conv":                      # (in, kh, kw) -> (kh, kw, in)
        row, col = np.transpose(row, (1, 2, 0)), np.transpose(col, (1, 2, 0))
    if name == "square":
        row, col = col, row
    return {"v_row": row, "v_col": col}


@pytest.mark.parametrize("weight_decay,anneal", [(0.0, 0), (0.05, 0), (0.05, 4)])
def test_adafactor_matches_optax(weight_decay, anneal):
    """Five updates on a tree of a factored Linear (and a square one), a
    factored conv, an unfactored conv and a bias: parameters within 1e-6
    of the largest, the state within 1e-5 relative."""
    lr = 1e-2
    init = _tree(0)
    schedule = (optax.linear_schedule(lr, 0.0, anneal) if anneal else lr)
    opt = optax.adafactor(learning_rate=schedule,
                          weight_decay_rate=(weight_decay or None))
    jparams = {k: jnp.asarray(v) for k, v in init.items()}
    jstate = opt.init(jparams)
    tparams = {k: torch.nn.Parameter(torch.from_numpy(
        np.ascontiguousarray(TO_TORCH[v.ndim](v)))) for k, v in init.items()}
    config = ttl.TrainConfig(lr=lr, optimizer="adafactor",
                             weight_decay=weight_decay, lr_anneal_steps=anneal)
    topt = ttl.make_optimizer(config, list(tparams.values()))
    assert isinstance(topt, taf.Adafactor)
    for step in range(5):
        grads = _tree(100 + step)
        if step == 2:
            grads["bias"][:] = 0.0          # a zero gradient: only decay moves it
        updates, jstate = opt.update({k: jnp.asarray(v) for k, v in grads.items()},
                                     jstate, jparams)
        jparams = optax.apply_updates(jparams, updates)
        for k, p in tparams.items():
            p.grad = torch.from_numpy(np.ascontiguousarray(TO_TORCH[grads[k].ndim](
                grads[k])))
        for group in topt.param_groups:
            group["lr"] = ttl.lr_at(config, step)
        topt.step()
    pmax = max(np.abs(np.asarray(v)).max() for v in jparams.values())
    for k, p in tparams.items():
        want = np.asarray(jparams[k])
        got = _from_torch(p.detach().numpy())
        assert np.abs(got - want).max() <= 1e-6 * pmax, k
    fstate = jstate[0]
    assert int(fstate.count) == 5
    for k, p in tparams.items():
        st = topt.state[p]
        assert st["count"] == 5
        got = _torch_state_as_flax(k, st)
        for key, val in got.items():
            want = np.asarray(getattr(fstate, key)[k])
            np.testing.assert_allclose(val, want, rtol=1e-5, atol=0, err_msg=f"{k} {key}")
        assert set(got) == ({"v"} if taf.factored_dims(p.shape) is None
                            else {"v_row", "v_col"})


def test_factored_dims_match_optax():
    from optax._src import factorized

    for shape in [(136, 200), (200, 136), (128, 128), (3, 3, 128, 130),
                  (130, 128, 3, 3), (3, 3, 8, 16), (200,), (127, 4096), (1152, 256)]:
        assert taf.factored_dims(shape) == factorized._factored_dims(shape, True, 128)


def _data(seed=0, b=2):
    rng = np.random.default_rng(seed)
    while True:
        yield (rng.standard_normal((b, 4, 128, 16)).astype(np.float32),
               {"y": rng.integers(0, 3, size=b)})


def _loop(tmp_path, name):
    model = init_weights_(DiT_models["DiTRotary_XS_8"](num_classes=3),
                          torch.Generator().manual_seed(1))
    with torch.no_grad():
        for p in model.parameters():
            p.add_(0.02 * torch.randn(p.shape, generator=torch.Generator().manual_seed(
                p.numel())))
    config = ttl.TrainConfig(lr=1e-3, optimizer="adafactor", weight_decay=0.01,
                             lr_anneal_steps=10, ema_rate=0.9, log_interval=1,
                             save_interval=10**6)
    return ttl.TrainLoop(model=model,
                         tables=tschedule.make_schedule("linear", 1000).tables("cpu"),
                         data=_data(), config=config,
                         checkpoint_dir=str(tmp_path / name), seed=3)


def test_adafactor_state_round_trips_through_a_checkpoint(tmp_path):
    """Three steps straight against two, a save, a restore into a fresh
    loop and the third: parameters, EMA and the optimizer state equal."""
    logger.configure(dir=str(tmp_path / "log"), format_strs=[])
    straight = _loop(tmp_path, "straight")
    straight.run_loop(max_steps=3)
    first = _loop(tmp_path, "first")
    first.run_loop(max_steps=2)             # saves step_000002 at its end
    resumed = _loop(tmp_path, "resumed")
    resumed.data = first.data
    resumed.rng, resumed.generator = first.rng, first.generator
    resumed.restore(first.latest_checkpoint(str(tmp_path / "first")))
    assert resumed.state.updates == 2
    resumed.run_loop(max_steps=1)
    for n, p in straight.model.state_dict().items():
        assert torch.equal(p, resumed.model.state_dict()[n]), n
        assert torch.equal(straight.state.ema_params[n], resumed.state.ema_params[n])
    a, b = straight.state.optimizer, resumed.state.optimizer
    for pa, pb in zip(straight.model.parameters(), resumed.model.parameters()):
        sa, sb = a.state[pa], b.state[pb]
        assert sa["count"] == sb["count"] == 3
        assert set(sa) == set(sb)
        for key in set(sa) - {"count"}:
            assert torch.equal(sa[key], sb[key])


def _manifest(tmp_path, n=4, length=1100):
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


def test_train_dit_adafactor_runs_and_resumes(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    flags = ["--data_dir", _manifest(tmp_path), "--model", "DiTRotary_XS_8",
             "--vae_path", FIXTURE, "--vae_arch", TINY_VAE_ARCH, "--pr_image_size",
             "1024", "--batch_size", "2", "--encode_rep", "1", "--log_interval",
             "1", "--device", "cpu", "--optimizer", "adafactor", "--bf16", "False",
             "--dir", "ada"]
    loop = train_dit.main([*flags, "--max_steps", "2"])
    assert isinstance(loop.state.optimizer, taf.Adafactor)
    assert loop.state.updates == 2
    ckpt = loop.latest_checkpoint(str(tmp_path / "loggings" / "ada" / "checkpoints"))
    assert os.path.basename(ckpt) == "step_000002"
    saved = torch.load(os.path.join(ckpt, "state.pt"), weights_only=True)
    counts = {s["count"] for s in saved["opt_state"]["state"].values()}
    assert counts == {2}
    resumed = train_dit.main([*flags, "--max_steps", "1", "--resume", "True"])
    assert resumed.resume_step == 2 and resumed.state.updates == 3
    assert {s["count"] for s in resumed.state.optimizer.state.values()} == {3}
