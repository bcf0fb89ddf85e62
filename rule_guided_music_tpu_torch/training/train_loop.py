"""Diffusion training: the train step, EMA, latent recombination, the loop.

Port of ``rule_guided_music_tpu/training/train_loop.py`` (reference
guided_diffusion/train_util.py:27-475). Parameters, gradients, the AdamW
moments and the EMA stay float32; with ``compute_dtype=torch.bfloat16``
the denoiser runs under ``torch.autocast`` (bf16 matmuls, norms in fp32),
as the JAX package runs bf16 modules over fp32 parameters, and the loss
is taken in fp32 on the model's fp32 output. On the card both kernels
take part: attention (forward with its log-sum-exp, and the backward
kernels) in every block, and GroupNorm+swish in the VAE encoder of
:func:`get_kl_input`, which runs without a gradient.

The JAX step is one jit over the global batch; here it is eager:
microbatches run one after another with their gradients summed and then
divided by their count (JAX's ``lax.scan`` order), a non-finite gradient
norm leaves the parameters, the optimizer state and the EMA as they were
(one host read of the norm per step), and the per-example terms come back
for the loss-aware sampler and the quartile logging. The noise and the
label-dropout mask of a step are drawn by :class:`TrainLoop` from its own
``torch.Generator`` (the JAX step splits its key inside the jit) and are
arguments of the step, so a test can feed both frameworks the same ones.
Checkpoints keep JAX's ``step_NNNNNN`` directories, ``keep_checkpoints``
and ``SCHEMA`` marker, with the port's own layout: ``torch.save`` of the
state dicts in ``state.pt``.
"""

from __future__ import annotations

import os
import os.path as osp
import re
import shutil
import time
from dataclasses import dataclass
from typing import Callable, Dict, Optional

import numpy as np
import torch

from ..constants import LATENT_CH, LATENT_PITCH
from ..diffusion import gaussian as gd
from ..diffusion.schedule import Tables
from ..utils import logger
from .resample import LossAwareSampler, ScheduleSampler, UniformSampler


def get_kl_input(vae_encode: Callable, batch: torch.Tensor,
                 scale_factor: float = 1.0, shift_size: int = 4,
                 recombine: bool = True) -> torch.Tensor:
    """Encode a long roll batch and unfold it into overlapping latent
    excerpts (train_util.py:403-429).

    batch: (B, 3, 128, L), L a multiple of 128, cut into 1.28 s chunks in
    the order "1st chunk of every roll, 2nd chunk of every roll, ...";
    ``vae_encode(chunks)`` gives their (n*B, 8, 16, 16) moments, and the
    posterior mode is kept. With ``recombine``, windows of 8 chunks at a
    stride of ``shift_size`` chunks: (B * windows, 4, 128, 16), times
    ``scale_factor``. The encoder runs without a gradient."""
    b, c, h, length = batch.shape
    seq_len = length // h
    chunks = batch.reshape(b, c, h, seq_len, h).permute(3, 0, 1, 2, 4)
    chunks = chunks.reshape(seq_len * b, c, h, h)
    with torch.no_grad():
        moments = vae_encode(chunks)                  # (seq*B, 8, 16, 16)
    z = torch.chunk(moments.float(), 2, dim=1)[0]     # posterior mode
    p = z.shape[-1]
    z = z.reshape(seq_len, b, LATENT_CH, p, p).permute(1, 2, 3, 0, 4)
    z = z.reshape(b, LATENT_CH, p, seq_len * p).transpose(2, 3)   # (B, 4, seq*16, 16)
    if recombine:
        window, step = 8 * 16, 16 * shift_size
        n_windows = (z.shape[2] - window) // step + 1
        wins = torch.stack([z[:, :, i * step:i * step + window, :]
                            for i in range(n_windows)], dim=1)
        z = wins.reshape(b * n_windows, LATENT_CH, window, LATENT_PITCH)
    return z.contiguous() * scale_factor


@dataclass
class TrainConfig:
    lr: float = 1e-4
    optimizer: str = "adamw"       # adamw (adafactor: ROADMAP queue 1, item 12)
    weight_decay: float = 0.0
    lr_anneal_steps: int = 0
    ema_rate: float = 0.9999
    microbatch: int = -1           # per-step microbatch (after encode_rep)
    encode_rep: int = 4
    shift_size: int = 4
    scale_factor: float = 1.0
    log_interval: int = 10
    save_interval: int = 10000
    keep_checkpoints: int = 0      # keep only the newest K step_* dirs (0 = all)
    eval_interval: int = -1
    profile_step: int = -1         # torch.profiler-trace this one step (-1 = off)
    skip_nan_steps: bool = True    # drop updates with non-finite grads
    ema_dtype: str = "float32"     # bfloat16 halves the EMA copy
    mean_type: gd.ModelMeanType = gd.ModelMeanType.EPSILON
    var_type: gd.ModelVarType = gd.ModelVarType.FIXED_LARGE
    loss_type: gd.LossType = gd.LossType.MSE


def lr_at(config: TrainConfig, count: int) -> float:
    """The learning rate of update ``count`` (0-based): constant, or
    optax's linear schedule from ``lr`` to 0 over ``lr_anneal_steps``."""
    if not config.lr_anneal_steps:
        return config.lr
    frac = 1.0 - min(max(count, 0), config.lr_anneal_steps) / config.lr_anneal_steps
    return config.lr * frac


def make_optimizer(config: TrainConfig, params) -> torch.optim.Optimizer:
    """AdamW with optax's defaults (b1 0.9, b2 0.999, eps 1e-8, weight
    decay decoupled and scaled by the learning rate), as JAX's
    ``optax.adamw(schedule, weight_decay=...)``; the schedule is applied by
    the step (:func:`lr_at`). ``adafactor`` is not ported."""
    if config.optimizer == "adafactor":
        raise NotImplementedError(
            "--optimizer adafactor is not in the torch port yet (ROADMAP.md, "
            "queue 1, item 12); use adamw")
    if config.optimizer != "adamw":
        raise ValueError(f"unknown optimizer {config.optimizer!r}")
    return torch.optim.AdamW(params, lr=config.lr, betas=(0.9, 0.999), eps=1e-8,
                             weight_decay=config.weight_decay)


def global_norm(tensors) -> torch.Tensor:
    """The L2 norm over every element of ``tensors`` (optax.global_norm)."""
    norms = torch._foreach_norm([t.float() for t in tensors])
    return torch.linalg.vector_norm(torch.stack(norms))


@dataclass
class TrainState:
    """What a step reads and writes: the model (its parameters are the
    fp32 masters), the EMA of each parameter by name, the optimizer, the
    count of steps taken and of updates applied (skipped steps count as
    steps, not as updates, as JAX's opt-state count stands still)."""

    model: torch.nn.Module
    ema_params: Dict[str, torch.Tensor]
    optimizer: torch.optim.Optimizer
    step: int = 0
    updates: int = 0


def init_ema(model: torch.nn.Module, ema_dtype: str = "float32") -> Dict[str, torch.Tensor]:
    dtype = getattr(torch, ema_dtype)
    return {name: p.detach().to(dtype, copy=True)
            for name, p in model.named_parameters()}


def _autocast(device: torch.device, compute_dtype: Optional[torch.dtype]):
    return torch.autocast(device.type, dtype=compute_dtype or torch.float32,
                          enabled=compute_dtype is not None)


def _model_fn(model, y, drop, compute_dtype, params=None):
    """The denoiser closure of ``training_losses``: train mode (label
    dropout by ``drop``), under autocast where ``compute_dtype`` is set;
    ``params``, by name, stand in for the module's (the EMA)."""
    device = next(model.parameters()).device

    def model_fn(x, model_t, **kw):
        with _autocast(device, compute_dtype):
            if params is None:
                return model(x, model_t, y, train=True, drop=drop)
            return torch.func.functional_call(
                model, params, (x, model_t, y), dict(train=True, drop=drop))
    return model_fn


def make_train_step(model: torch.nn.Module, tables: Tables, config: TrainConfig,
                    compute_dtype: Optional[torch.dtype] = None):
    """The train step over the (global) batch:
    ``step_fn(state, latents, t, weights, y, noise, drop) -> metrics``,
    updating ``state`` in place. ``noise`` has the latents' shape; ``drop``
    is the (B,) label-dropout mask or None. Metrics: loss, grad_norm,
    param_norm, skipped (0-d tensors), per_example_loss and
    per_example_mse ((B,)), and vb (its mean) where the loss has one."""

    def loss_fn(latents, t, weights, y, noise, drop):
        terms = gd.training_losses(
            tables, _model_fn(model, y, drop, compute_dtype), latents, t, noise,
            mean_type=config.mean_type, var_type=config.var_type,
            loss_type=config.loss_type)
        return (terms["loss"] * weights).mean(), terms

    def step_fn(state: TrainState, latents, t, weights, y, noise, drop=None):
        params = [p for p in state.model.parameters() if p.requires_grad]
        for p in params:
            p.grad = None
        b = latents.shape[0]
        n_micro = max(b // config.microbatch, 1) if config.microbatch > 0 else 1
        if b % n_micro:
            raise ValueError(f"batch {b} does not split into {n_micro} microbatches")
        m = b // n_micro
        pick = lambda a, i: None if a is None else a[i * m:(i + 1) * m]
        loss_sum, terms_all = 0.0, []
        for i in range(n_micro):
            loss, terms = loss_fn(*(pick(a, i) for a in (latents, t, weights, y,
                                                          noise, drop)))
            loss.backward()
            loss_sum = loss_sum + loss.detach()
            terms_all.append({k: v.detach() for k, v in terms.items()})
        grads = [p.grad if p.grad is not None else torch.zeros_like(p)
                 for p in params]
        if n_micro > 1:
            torch._foreach_div_(grads, float(n_micro))
        loss = loss_sum / n_micro
        terms = {k: torch.cat([d[k] for d in terms_all]) for k in terms_all[0]}
        # bf16 needs no loss scaling, but a non-finite batch must not poison
        # the params: skip the update, the optimizer state and the EMA
        grad_norm = global_norm(grads)
        ok = bool(torch.isfinite(grad_norm)) or not config.skip_nan_steps
        if ok:
            for p, g in zip(params, grads):
                p.grad = g
            for group in state.optimizer.param_groups:
                group["lr"] = lr_at(config, state.updates)
            state.optimizer.step()
            state.updates += 1
            _ema_update(state, config.ema_rate)
        for p in params:
            p.grad = None
        state.step += 1
        metrics = {
            "loss": loss,
            "grad_norm": grad_norm,
            "param_norm": global_norm([p.detach() for p in params]),
            "skipped": torch.tensor(0.0 if ok else 1.0),
            "per_example_loss": terms["loss"],
            "per_example_mse": terms.get("mse", terms["loss"]),
        }
        if "vb" in terms:
            metrics["vb"] = terms["vb"].mean()
        return metrics

    return step_fn


@torch.no_grad()
def _ema_update(state: TrainState, rate: float) -> None:
    """ema = ema * rate + params * (1 - rate), in fp32, stored in the
    EMA's dtype."""
    names, params = zip(*[(n, p.detach()) for n, p in state.model.named_parameters()
                          if p.requires_grad])
    ema = [state.ema_params[n] for n in names]
    if ema[0].dtype == torch.float32:
        torch._foreach_mul_(ema, rate)
        torch._foreach_add_(ema, params, alpha=1.0 - rate)
    else:
        for e, p in zip(ema, params):
            e.copy_(e.float() * rate + p.float() * (1.0 - rate))


def make_eval_loss_step(model: torch.nn.Module, tables: Tables, config: TrainConfig,
                        compute_dtype: Optional[torch.dtype] = None):
    """Forward-only diffusion loss on a held-out batch under the EMA
    parameters (reference run_step_eval, train_util.py:222-254):
    ``eval_fn(ema_params, latents, t, y, noise, drop) -> terms``."""

    @torch.no_grad()
    def eval_fn(ema_params, latents, t, y, noise, drop=None):
        ref = dict(model.named_parameters())
        params = {k: v.to(ref[k].dtype) for k, v in ema_params.items()}
        return gd.training_losses(
            tables, _model_fn(model, y, drop, compute_dtype, params), latents, t,
            noise, mean_type=config.mean_type, var_type=config.var_type,
            loss_type=config.loss_type)

    return eval_fn


def log_loss_dict(num_timesteps: int, ts: np.ndarray, losses: Dict[str, np.ndarray]):
    """Quartile-binned loss logging (train_util.py:469-475)."""
    for key, values in losses.items():
        values = np.asarray(values)
        logger.logkv_mean(key, float(values.mean()))
        for sub_t, sub_loss in zip(np.asarray(ts), values):
            quartile = int(4 * sub_t / num_timesteps)
            logger.logkv_mean(f"{key}_q{quartile}", float(sub_loss))


class TrainLoop:
    """Host-side orchestration: data, t-sampling, the step's noise and
    label-dropout draws, logging, checkpointing. ``model`` holds fp32
    parameters on its device; ``vae_encode(chunks) -> moments`` encodes the
    loader's rolls (``get_kl_input``) where given."""

    # Checkpoint layout version: {params, ema_params, opt_state, step,
    # updates} as one torch.save under step_NNNNNN/state.pt.
    CKPT_SCHEMA = "rule-guided-music-tpu-torch/v1"

    def __init__(self, *, model: torch.nn.Module, tables: Tables, data,
                 config: TrainConfig, vae_encode: Optional[Callable] = None,
                 schedule_sampler: Optional[ScheduleSampler] = None,
                 checkpoint_dir: Optional[str] = None,
                 eval_fn: Optional[Callable] = None, eval_data=None, seed: int = 0,
                 compute_dtype: Optional[torch.dtype] = None):
        self.model = model
        self.device = next(model.parameters()).device
        self.tables = tables
        self.data = data
        self.config = config
        self.vae_encode = vae_encode
        self.schedule_sampler = schedule_sampler or UniformSampler(
            tables.num_timesteps)
        self.checkpoint_dir = checkpoint_dir
        self.eval_fn = eval_fn
        self.eval_data = eval_data
        self.rng = np.random.default_rng(seed)
        self.generator = torch.Generator(device=self.device).manual_seed(seed)
        self.state = TrainState(
            model=model, ema_params=init_ema(model, config.ema_dtype),
            optimizer=make_optimizer(config, [p for p in model.parameters()
                                              if p.requires_grad]))
        self.step_fn = make_train_step(model, tables, config, compute_dtype)
        self.eval_loss_fn = (make_eval_loss_step(model, tables, config, compute_dtype)
                             if eval_data is not None else None)
        self.trace = None           # the profiled step's logger.TraceSummary
        self.step_ms = []           # host wall ms of each step, loading included
        self.step = 0
        self.resume_step = 0

    # -- checkpointing ------------------------------------------------------

    def save(self):
        if self.checkpoint_dir is None:
            return
        step = self.step + self.resume_step
        path = osp.join(osp.abspath(self.checkpoint_dir), f"step_{step:06d}")
        os.makedirs(path, exist_ok=True)
        s = self.state
        torch.save({"params": s.model.state_dict(), "ema_params": s.ema_params,
                    "opt_state": s.optimizer.state_dict(), "step": s.step,
                    "updates": s.updates}, osp.join(path, "state.pt"))
        # schema marker: lets a reader check the layout before restoring
        with open(osp.join(path, "SCHEMA"), "w") as f:
            f.write(f"{self.CKPT_SCHEMA}\n")
        logger.log(f"saved checkpoint {path}")
        self._prune_checkpoints()

    def _prune_checkpoints(self):
        keep = self.config.keep_checkpoints
        if not keep or self.checkpoint_dir is None:
            return
        base = osp.abspath(self.checkpoint_dir)
        ckpts = sorted(d for d in os.listdir(base) if d.startswith("step_"))
        for d in ckpts[:-keep]:
            shutil.rmtree(osp.join(base, d), ignore_errors=True)
            logger.log(f"pruned old checkpoint {d}")

    def restore(self, path: str):
        schema_file = osp.join(path, "SCHEMA")
        if osp.exists(schema_file):
            schema = open(schema_file).read().strip()
            if schema != self.CKPT_SCHEMA:
                raise ValueError(f"checkpoint schema {schema!r} != {self.CKPT_SCHEMA!r}")
        saved = torch.load(osp.join(path, "state.pt"), map_location=self.device,
                           weights_only=True)
        s = self.state
        s.model.load_state_dict(saved["params"])
        with torch.no_grad():
            for name, e in s.ema_params.items():
                e.copy_(saved["ema_params"][name])
        s.optimizer.load_state_dict(saved["opt_state"])
        s.step, s.updates = int(saved["step"]), int(saved["updates"])
        self.resume_step = s.step
        m = re.search(r"step_(\d+)", path)
        if m:
            self.resume_step = int(m.group(1))
        logger.log(f"resumed from {path} at step {self.resume_step}")

    @staticmethod
    def latest_checkpoint(checkpoint_dir: str) -> Optional[str]:
        if not osp.isdir(checkpoint_dir):
            return None
        ckpts = sorted(d for d in os.listdir(checkpoint_dir) if d.startswith("step_"))
        return osp.join(osp.abspath(checkpoint_dir), ckpts[-1]) if ckpts else None

    # -- main loop ----------------------------------------------------------

    def _prepare_batch(self, batch: np.ndarray, cond: Dict[str, np.ndarray]):
        """Shared train/eval preprocessing: VAE-encode + recombine, repeat
        labels by encode_rep, sample (t, weights)."""
        batch = torch.as_tensor(np.asarray(batch, dtype=np.float32),
                                device=self.device)
        if self.vae_encode is not None:
            latents = get_kl_input(self.vae_encode, batch,
                                   scale_factor=self.config.scale_factor,
                                   shift_size=self.config.shift_size)
            rep = latents.shape[0] // batch.shape[0]
        else:
            latents, rep = batch, 1
        y = cond.get("y")
        if y is not None:
            y = torch.as_tensor(np.repeat(np.asarray(y), rep), dtype=torch.long,
                                device=self.device)
        t_np, w_np = self.schedule_sampler.sample(latents.shape[0], self.rng)
        t = torch.as_tensor(t_np, dtype=torch.long, device=self.device)
        w = torch.as_tensor(w_np, device=self.device)
        return latents, t_np, t, w_np, w, y

    def draw(self, latents: torch.Tensor, y: Optional[torch.Tensor]):
        """The step's noise, and its label-dropout mask where the model
        drops labels, from the loop's generator."""
        noise = torch.randn(latents.shape, generator=self.generator,
                            device=self.device)
        emb = getattr(self.model, "y_embedder", None)
        drop = None
        if y is not None and emb is not None and emb.dropout_prob > 0:
            drop = torch.rand(y.shape, generator=self.generator,
                              device=self.device) < emb.dropout_prob
        return noise, drop

    def run_step(self, batch: np.ndarray, cond: Dict[str, np.ndarray]):
        latents, t_np, t, w_np, w, y = self._prepare_batch(batch, cond)
        metrics = self.step_fn(self.state, latents, t, w, y, *self.draw(latents, y))
        per_loss = metrics["per_example_loss"].cpu().numpy()
        if isinstance(self.schedule_sampler, LossAwareSampler):
            self.schedule_sampler.update_with_all_losses(t_np, per_loss)
        log_loss_dict(self.tables.num_timesteps, t_np,
                      {"loss": per_loss * w_np,
                       "mse": metrics["per_example_mse"].cpu().numpy() * w_np})
        logger.logkv("grad_norm", float(metrics["grad_norm"]))
        logger.logkv("param_norm", float(metrics["param_norm"]))
        return metrics

    def run_step_eval(self, batch: np.ndarray, cond: Dict[str, np.ndarray]):
        """Held-out batch loss under the EMA parameters, logged as
        ``eval_*`` quartile keys (reference run_step_eval)."""
        latents, t_np, t, w_np, _, y = self._prepare_batch(batch, cond)
        terms = self.eval_loss_fn(self.state.ema_params, latents, t, y,
                                  *self.draw(latents, y))
        log_loss_dict(self.tables.num_timesteps, t_np,
                      {f"eval_{k}": v.cpu().numpy() * w_np for k, v in terms.items()})
        return terms

    def run_loop(self, max_steps: Optional[int] = None):
        cfg = self.config
        while ((not cfg.lr_anneal_steps
                or self.step + self.resume_step < cfg.lr_anneal_steps)
               and (max_steps is None or self.step < max_steps)):
            t0 = time.perf_counter()
            batch, cond = next(self.data)
            if self.step == cfg.profile_step:
                with logger.torch_trace() as self.trace:
                    self.run_step(batch, cond)
            else:
                self.run_step(batch, cond)
            # run_step ends reading its metrics, so the device has finished
            self.step_ms.append(1e3 * (time.perf_counter() - t0))
            if self.eval_data is not None and self.eval_loss_fn is not None \
                    and cfg.eval_interval > 0 and self.step % cfg.eval_interval == 0:
                self.run_step_eval(*next(self.eval_data))
            if self.eval_fn is not None and cfg.eval_interval > 0 and \
                    self.step % cfg.eval_interval == 0:
                self.eval_fn(self)
            if self.step % cfg.log_interval == 0:
                logger.logkv("step", self.step + self.resume_step)
                logger.dumpkvs()
            if self.step % cfg.save_interval == 0 and self.step != 0:
                self.save()
                if os.environ.get("DIFFUSION_TRAINING_TEST", "") and self.step > 0:
                    return
            self.step += 1
        if (self.step - 1) % cfg.save_interval != 0:
            self.save()


def make_eval_sampling_fn(model: torch.nn.Module, tables: Tables, *, vae=None,
                          sample_batch_size: int = 16, num_classes: int = 0,
                          in_channels: int = 4, image_size=(128, 16),
                          use_ddim: bool = True, fs: int = 100,
                          scale_factor: float = 1.0,
                          compute_dtype: Optional[torch.dtype] = None):
    """Training-time eval hook: sample with the EMA parameters on the
    port's sampler, decode, and write MIDI under
    ``<logdir>/samples/iter_<step>`` (train_util.py:222-317);
    class-balanced labels. ``vae`` (an AutoencoderKL) decodes where given."""
    from ..config import SamplerConfig
    from ..constants import BACKGROUND_THRESHOLD
    from ..data.pianoroll import finalize_decoded_sample, save_piano_roll_midi
    from ..diffusion.latent import make_decode_fn
    from ..diffusion.sampling import sample_loop, torch_noise_fn

    config = SamplerConfig(sampler="ddim" if use_ddim else "ddpm", eta=1.0)
    shape = (sample_batch_size, in_channels, *image_size)
    device = next(model.parameters()).device

    @torch.no_grad()
    def eval_fn(loop: TrainLoop):
        ref = dict(model.named_parameters())
        params = {k: v.to(ref[k].dtype) for k, v in loop.state.ema_params.items()}
        gen = torch.Generator(device=device).manual_seed(loop.step + 12345)
        if num_classes > 0:
            per = max(sample_batch_size // num_classes, 1)
            y = (torch.arange(sample_batch_size, device=device) // per).clamp(
                0, num_classes - 1)
        else:
            y = None

        def model_fn(x, t, yy):
            with _autocast(device, compute_dtype):
                return torch.func.functional_call(model, params, (x, t, yy))

        latents = sample_loop(model_fn, shape, tables, config,
                              noise_fn=torch_noise_fn(gen, device), y=y)[0]
        rolls = latents
        if vae is not None:
            rolls = make_decode_fn(vae.decode, scale_factor=scale_factor)(latents)
        arr = finalize_decoded_sample(rolls.float().cpu().numpy(),
                                      BACKGROUND_THRESHOLD)
        step = loop.step + loop.resume_step
        save_dir = osp.join(logger.get_dir(), "samples", f"iter_{step}")
        save_piano_roll_midi(arr, save_dir, fs,
                             y=None if y is None else y.cpu().numpy())
        logger.log(f"eval samples written to {save_dir}")

    return eval_fn
