"""An 8-step, k=4 SCG chain on the quality_tiny fixture in both frameworks.

The port's ``noise_fn`` replays the JAX sampler's key split order
(sampling.py:569 for x_T, :591-592 per step), so both chains see the same
numbers. The selected candidate must be the same at every step; the final
latents agree to 1e-3 (float32 on both sides; the selection makes the
chains identical up to the models' ~1e-5 float differences, which the
8-step recursion amplifies by the 1/sqrt(alpha) factors of the x0 rollout).
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import torch

from rule_guided_music_tpu.diffusion import sampling as jsampling
from rule_guided_music_tpu.diffusion import schedule as jschedule
from rule_guided_music_tpu.diffusion.latent import make_decode_fn as jmake_decode
from rule_guided_music_tpu.models import AutoencoderKL as JaxVAE
from rule_guided_music_tpu.models import DiT_models as JaxDiT
from rule_guided_music_tpu.rules.registry import FUNC_DICT as JFUNC
from rule_guided_music_tpu.utils.fixtures import load_fixture_npz, make_rolls
from rule_guided_music_tpu_torch import config as tconfig
from rule_guided_music_tpu_torch import pipeline
from rule_guided_music_tpu_torch.diffusion import schedule as tschedule

FIXTURE = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                       "fixtures", "quality_tiny.npz")
TINY_VAE = dict(ch=32, ch_mult=(1, 1, 2, 2), num_res_blocks=1)
RULES = ("pitch_hist", "note_density", "chord_progression")
WEIGHTS = (("pitch_hist", 40.0), ("note_density", 1.0), ("chord_progression", 1.0))


def jax_replay_noise(seed: int, num_steps: int):
    """noise_fn drawing what ``sample_loop(PRNGKey(seed), ...)`` draws."""
    rng, init_rng = jax.random.split(jax.random.PRNGKey(seed))
    step_keys = []
    for _ in range(num_steps):
        rng, noise_rng, scg_rng = jax.random.split(rng, 3)
        step_keys.append({"step": noise_rng, "scg": scg_rng})

    def noise_fn(kind, step, shape):
        key = init_rng if kind == "init" else step_keys[step][kind]
        return torch.as_tensor(np.array(jax.random.normal(key, shape)))

    return noise_fn


def test_scg_chain_matches_jax():
    steps, k, b, seed = 8, 4, 1, 5
    fx = load_fixture_npz(FIXTURE)
    jdit = JaxDiT["DiTRotary_XS_8"](input_size=(128, 16), in_channels=4,
                                   num_classes=0)
    jvae = JaxVAE(**TINY_VAE)
    jt = jschedule.make_schedule("linear", 1000, str(steps)).tables()
    rolls = make_rolls(2, seed=21)[1:]
    jrules = {n: JFUNC[n](jnp.asarray(rolls)) for n in RULES}
    jcfg = jsampling.SamplerConfig(
        guidance=jsampling.GuidanceConfig(schedule=True, t_start=750),
        scg=jsampling.SCGConfig(num_samples=k, weights=WEIGHTS), record=True)
    decode = jmake_decode(
        lambda z: jvae.apply(fx["vae"], z, method=JaxVAE.decode), 1.0)
    run = jax.jit(lambda key, rules: jsampling.sample_loop(
        key, lambda x, t, y=None: jdit.apply(fx["dit"], x, t), (b, 4, 128, 16),
        jt, jcfg, rules=rules, decode_fn=decode))
    with jax.default_matmul_precision("highest"):
        jx, jrec = run(jax.random.PRNGKey(seed), jrules)
    jsel = np.asarray(jrec["candidate_log_prob"]).argmax(axis=1)

    tdit = pipeline.create_denoiser("DiTRotary_XS_8", num_classes=0,
                                    model_path=FIXTURE, dtype=torch.float32,
                                    device="cpu")
    tvae = pipeline.create_vae(FIXTURE, arch=TINY_VAE, dtype=torch.float32,
                               device="cpu")
    tt = tschedule.make_schedule("linear", 1000, str(steps)).tables("cpu")
    tcfg = tconfig.SamplerConfig(
        guidance=tconfig.GuidanceConfig(schedule=True, t_start=750),
        scg=tconfig.SCGConfig(num_samples=k, weights=WEIGHTS), record=True)
    trules = pipeline.extract_targets_from_rolls(RULES, torch.as_tensor(rolls))
    tx, trec = pipeline.generate(tdit, tvae, tt, tcfg, (b, 4, 128, 16), trules,
                                 noise_fn=jax_replay_noise(seed, steps),
                                 num_classes=0, scale_factor=1.0)
    tsel = trec["candidate_log_prob"].numpy().argmax(axis=1)

    guided = np.asarray(jrec["candidate_log_prob"]).any(axis=(1, 2))
    assert guided.sum() == steps - 1          # every step but t == t_end
    np.testing.assert_array_equal(tsel, jsel)
    np.testing.assert_allclose(tx.numpy(), np.asarray(jx), rtol=0, atol=1e-3)
    for name in ("loss/pitch_hist", "loss/note_density", "loss/chord_progression"):
        np.testing.assert_allclose(trec[name].numpy(), np.asarray(jrec[name]),
                                   rtol=1e-3, atol=1e-4, err_msg=name)
