"""``correct`` at fixture size on the CPU: a sound run of each cell's
driver is correct; with the timed path broken underneath (each fault the
cell can have, planted in the program) it is not; and the control, the
reference computed in float8 in the program's place, fails the cell's
limits. The harness's look for a card is skipped: the drivers run on the
CPU with the port's plain versions, in float32."""

import pytest
import torch

import tiny
from harness import common

SAMPLING = ["xl8_sample.scg_cls_b4", "xl8_sample.scg_b4", "xl8_sample.ddim100_b32"]
TRAIN = ["xl8_train.adamw_b32"]


def run(name):
    cell = tiny.cell(name)
    result, check = cell.driver.run(tiny.ctx(cell))
    return check


def _dit_output(monkeypatch):
    from rule_guided_music_tpu_torch.models import dit

    forward = dit.DiTRotary.forward
    monkeypatch.setattr(dit.DiTRotary, "forward",
                        lambda self, *a, **k: forward(self, *a, **k) * 1.1)


def _state_unchanged(monkeypatch):
    from rule_guided_music_tpu_torch.diffusion import gaussian, sampling

    pmv = gaussian.p_mean_variance

    def frozen(tables, out, x, t, **kw):
        p = pmv(tables, out, x, t, **kw)
        return p._replace(mean=x, pred_xstart=x, eps=torch.zeros_like(x))
    monkeypatch.setattr(sampling.gd, "p_mean_variance", frozen)


def _pick_altered(monkeypatch):
    """The rule scores turned round where the sampler makes them: each
    guided step keeps its worst candidate."""
    from rule_guided_music_tpu_torch.diffusion import sampling

    for rule in ("pitch_hist", "note_density", "chord_progression"):
        loss = sampling.LOSS_DICT[rule]
        monkeypatch.setitem(sampling.LOSS_DICT, rule, lambda a, b, loss=loss: -loss(a, b))


def _candidates_duplicated(monkeypatch):
    """Every SCG candidate drawn from the first candidate's noise: the k
    candidates collapse onto one."""
    from rule_guided_music_tpu_torch.diffusion import sampling

    select = sampling._scg_select

    def collapsed(config, tables, model_fn, decode_fn, rules, noise, *a, **k):
        return select(config, tables, model_fn, decode_fn, rules,
                      noise[:1].expand_as(noise).clone(), *a, **k)
    monkeypatch.setattr(sampling, "_scg_select", collapsed)


def _x0_wrong(monkeypatch):
    """The candidates' rolled-out x0 off by a quarter (a wrong alpha or
    scale) before the decode that scores them."""
    from rule_guided_music_tpu_torch.diffusion import sampling

    rollout = sampling._rollout_x0
    monkeypatch.setattr(sampling, "_rollout_x0", lambda *a, **k: rollout(*a, **k) * 1.25)


def _optimizer_skipped(monkeypatch):
    monkeypatch.setattr(torch.optim.AdamW, "step", lambda self, closure=None: None)


def _optimizer_skipped_after_warmup(monkeypatch):
    """The optimizer steps through the set-up steps, then stops: a path
    that changes once the window starts."""
    step, calls = torch.optim.AdamW.step, []

    def late(self, closure=None):
        calls.append(1)
        return step(self, closure) if len(calls) <= 3 else None
    monkeypatch.setattr(torch.optim.AdamW, "step", late)


def _loss_altered_after_warmup(monkeypatch):
    from rule_guided_music_tpu_torch.diffusion import gaussian

    losses, calls = gaussian.training_losses, []

    def scaled(*a, **k):
        calls.append(1)
        terms = losses(*a, **k)
        return terms if len(calls) <= 3 else dict(terms, loss=terms["loss"] * 1.1)
    monkeypatch.setattr(gaussian, "training_losses", scaled)


def _half_batch(monkeypatch):
    from rule_guided_music_tpu_torch.training import train_loop

    make = train_loop.make_train_step

    def halved(*a, **k):
        step = make(*a, **k)

        def step_fn(state, *xs):
            # the update from the first half alone; the per-example metrics
            # keep the batch's length, so nothing else looks amiss
            m = step(state, *(None if x is None else x[:len(x) // 2] for x in xs))
            return {k: v.repeat(2) if k.startswith("per_example") else v
                    for k, v in m.items()}
        return step_fn
    monkeypatch.setattr(train_loop, "make_train_step", halved)


def _loss_altered(monkeypatch):
    from rule_guided_music_tpu_torch.diffusion import gaussian

    losses = gaussian.training_losses

    def scaled(*a, **k):
        terms = losses(*a, **k)
        return dict(terms, loss=terms["loss"] * 1.1)
    monkeypatch.setattr(gaussian, "training_losses", scaled)


FAULTS = ([(c, f) for c in SAMPLING for f in (_dit_output, _state_unchanged)]
          + [(c, f) for c in SAMPLING if "scg" in c
             for f in (_pick_altered, _candidates_duplicated, _x0_wrong)]
          + [(c, f) for c in TRAIN for f in (_optimizer_skipped, _half_batch, _loss_altered,
                                             _optimizer_skipped_after_warmup,
                                             _loss_altered_after_warmup)])


@pytest.mark.parametrize("name", SAMPLING + TRAIN)
def test_sound_run_is_correct(name):
    check = run(name)
    assert check.correct, check.table()


@pytest.mark.parametrize("name,fault", FAULTS, ids=[f"{c}-{f.__name__[1:]}" for c, f in FAULTS])
def test_broken_timed_path_is_not_correct(name, fault, monkeypatch):
    fault(monkeypatch)
    check = run(name)
    assert not check.correct, check.table()


@pytest.mark.parametrize("name", SAMPLING + TRAIN)
def test_control_fails_the_limits(name):
    cell = tiny.cell(name)
    rows = cell.driver.calibrate(cell, torch.device("cpu"), [5], lambda row: None)
    limits = common.load_cell(name).limits
    program, control = common.Check(limits), common.Check(limits)
    for k, v in rows[0]["program"].items():
        program.add(k, v)
    for k in limits:
        # a number the control cannot read (the pick, an exact comparison)
        # keeps the program's reading
        control.add(k, rows[0]["control"].get(k, rows[0]["program"][k]))
    assert program.correct and not control.correct, (program.table(), control.table())
