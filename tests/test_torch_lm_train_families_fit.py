"""The port's training slice for the SSM, hybrid and encoder-decoder
families, end to end, against the reference: six ``Trainer.fit`` steps,
LM checkpoints of the ``blocks``, ``enc_layers`` and ``dec_layers``
stacks crossing between the packages, and the train CLI for each family.
Smoke widths and the models of ``test_torch_lm_train_families``
(``_cfgs``, weights tamed by ``_tame``).
"""
import tempfile

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import torch_threads  # noqa: E402,F401  (cores shared among xdist's workers)

from repro.launch.train import lm_synthetic_batches as j_synthetic  # noqa: E402
from repro.optim import OptimizerConfig as JOptimizerConfig  # noqa: E402
from repro.train import Trainer as JTrainer  # noqa: E402
from repro.train import TrainerConfig as JTrainerConfig  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.launch import train as train_cli  # noqa: E402
from repro_torch.optim import OptimizerConfig  # noqa: E402
from repro_torch.train import Trainer, TrainerConfig  # noqa: E402

from test_torch_lm_train import TRAIN_OPT, _corpus_batches, _port_state  # noqa: E402
from test_torch_lm_train_families import ARCHS, BATCH, SEQ, _cfgs, _tame  # noqa: E402


# -- the Trainer ----------------------------------------------------------------------


def _fit_both(cfg, jcfg, batches, jbatches, steps=6):
    jtrainer = JTrainer(jcfg, JOptimizerConfig(**TRAIN_OPT), JTrainerConfig(max_steps=steps))
    jstate = jtrainer.init_state(0)
    _tame(jstate["params"])
    trainer = Trainer(cfg, OptimizerConfig(**TRAIN_OPT), TrainerConfig(max_steps=steps),
                      device="cpu")
    state = trainer.fit(iter(batches), _port_state(jstate, trainer.opt_cfg))
    jtrainer.fit(iter(jbatches), jstate)
    assert state["step"] == steps
    return [m.loss for m in trainer.history], [m.loss for m in jtrainer.history]


@pytest.mark.parametrize("case", ["ssm", "encdec"])
def test_trainer_fit_matches_reference(case):
    """Six ``Trainer.fit`` steps from the reference's initial state: the
    mamba2 SMOKE fed by ``lm_batches_from_table`` from a token corpus, the
    seamless SMOKE by ``lm_synthetic_batches``' frames and tokens: the
    first loss within 1e-5 of the reference's, the others within 1e-3
    (after the first step AdamW's g / (|g| + eps) turns the float32 noise
    of gradients near 0 into updates of the learning rate's size; measured
    up to 2.4e-4), the last below the first."""
    cfg, jcfg = _cfgs(case, "f32")
    if case == "ssm":
        batches = _corpus_batches(cfg, "port")
        jbatches = _corpus_batches(jcfg, "reference")
    else:
        batches = [b for _, b in zip(range(6), train_cli.lm_synthetic_batches(cfg, BATCH, SEQ))]
        jbatches = [b for _, b in zip(range(6), j_synthetic(jcfg, BATCH, SEQ))]
    assert len(batches) >= 6
    got, want = _fit_both(cfg, jcfg, batches, jbatches)
    np.testing.assert_allclose(got[0], want[0], rtol=1e-5)
    np.testing.assert_allclose(got, want, rtol=1e-3)
    assert got[-1] < got[0]


@pytest.mark.parametrize("writer", ["port", "reference"])
@pytest.mark.parametrize("case", ["hybrid", "encdec"])
def test_lm_checkpoint_crosses_packages(case, writer):
    """One package trains 2 steps and saves the ``blocks`` (hybrid) or the
    ``enc_layers`` and ``dec_layers`` (encoder-decoder) stacks; the other
    restores it and trains 2 more, within 1e-4 of the writer continuing
    itself."""
    cfg, jcfg = _cfgs(case, "f32")
    feed = list(zip(range(4), train_cli.lm_synthetic_batches(cfg, BATCH, SEQ)))
    batches = [b for _, b in feed]
    jbatches = [b for _, b in zip(range(4), j_synthetic(jcfg, BATCH, SEQ))]
    opt, jopt = OptimizerConfig(**TRAIN_OPT), JOptimizerConfig(**TRAIN_OPT)

    def jstate0():
        state = JTrainer(jcfg, jopt, JTrainerConfig(max_steps=1)).init_state(0)
        _tame(state["params"])
        return state

    def port(d, steps, feed, fresh):
        t = Trainer(cfg, opt, TrainerConfig(checkpoint_dir=d, max_steps=steps,
                                            checkpoint_every=2), device="cpu")
        t.fit(iter(feed), _port_state(jstate0(), opt) if fresh else None)
        return [m.loss for m in t.history]

    def ref(d, steps, feed, fresh):
        t = JTrainer(jcfg, jopt, JTrainerConfig(checkpoint_dir=d, max_steps=steps,
                                               checkpoint_every=2))
        t.fit(iter(feed), jstate0() if fresh else None)
        return [m.loss for m in t.history]

    write, read = (port, ref) if writer == "port" else (ref, port)
    wfeed, rfeed = (batches, jbatches) if writer == "port" else (jbatches, batches)
    with tempfile.TemporaryDirectory() as a, tempfile.TemporaryDirectory() as b:
        write(a, 2, wfeed[:2], True)
        write(b, 2, wfeed[:2], True)
        resumed = read(a, 4, rfeed[2:], False)
        itself = write(b, 4, wfeed[2:], False)
    assert len(resumed) == len(itself) == 2
    np.testing.assert_allclose(resumed, itself, rtol=1e-4)


# -- the CLI ----------------------------------------------------------------------------


@pytest.mark.parametrize("arch", list(ARCHS.values()))
def test_train_cli_trains_each_family(arch, capsys):
    """``--arch`` of the SSM, hybrid and encoder-decoder archs trains their
    SMOKE on the CPU: exit 0, so the last loss is below the first."""
    assert train_cli.main(["--arch", arch, "--smoke", "--device", "cpu", "--steps", "12",
                           "--batch-size", "8", "--seq", "128"]) == 0
    out = capsys.readouterr().out
    assert f"arch={configs.get_smoke_config(arch).name} device=cpu steps=12" in out
