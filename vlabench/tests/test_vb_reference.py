"""Each plain reference at a tiny size on the CPU: it agrees with the
program computed in fp32, a tiny run of each kind comes out correct under
the full configurations' limits, and the control and every fault the cell
can have come out not correct."""

import json

import numpy as np
import pytest
import torch

from vlabench import clients, control, core, run, weights
from vlabench.reference import plain
from vlabench.tests.vb_tiny import SERVE, TRAIN, checkout, limits_of


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    """A checkout with the tiny cells; the serving cell keeps the limits set
    from tiny readings (its decoder is two layers of width 64, so its gaps
    are its own), the training cell takes the full configuration's."""
    root = checkout(tmp_path_factory.mktemp("ref"))
    path = root / "vlabench/configs/dm0-tiny.json"
    config = json.loads(path.read_text())
    config["correctness"] = limits_of("dm0")
    path.write_text(json.dumps(config))
    return root


def ok(result):
    return all(c.ok for c in result["checks"])


def test_cogact_reference_is_the_program_in_fp32(root):
    from dexbotic_tpu_torch.exp.serve import prepare_cogact_inputs
    from dexbotic_tpu_torch.models.cogact import cogact_inference_action

    cell = core.load_cell(SERVE, root)
    system, ref, config = core.load_system(cell), core.load_reference(cell), cell.config
    plain.no_tf32()
    exp = system.make_exp(config, 0, "cpu")
    cfg = exp.model.build_config()
    model = exp.model.build_params(cfg, "cpu")
    weights.fill_(model, ref.inventory(config), 123)
    rng = np.random.default_rng(0)
    png, text = clients.frame_png(rng, 24, 32), clients.instruction(rng, 60)
    ids, valid, imgs = prepare_cogact_inputs(exp, cfg, exp.tokenizer.build_tokenizer(), [png], text, "cpu")
    assert ids[0].tolist() == ref.prompt_ids(config, text)
    np.testing.assert_allclose(imgs[0, 0].numpy(), ref.pixels(config, png), atol=1e-6)
    noise = torch.randn(1, 16, 7, generator=torch.Generator().manual_seed(5))
    got = cogact_inference_action(model, cfg, ids, valid, imgs, noise=noise)[0].double()
    W = ref.load_weights(config, 123, "cpu")
    z = ref.cognition(W, config, ref.prompt_ids(config, text), torch.from_numpy(ref.pixels(config, png)))
    want = ref.sample(W, config, z[None], noise)[0].double()
    assert float((got - want).abs().max() / want.abs().max()) < 1e-5


@pytest.mark.parametrize("cell", [SERVE, TRAIN])
def test_a_tiny_run_is_correct(root, cell):
    result = run.run_cell(core.load_cell(cell, root), 2 ** 31 + 21, 2.0, False, "cpu", 0.0)
    assert ok(result), [(c.name, c.value, c.limit) for c in result["checks"]]


def test_the_training_control_and_half_batch_fault_fail(root):
    cell = core.load_cell(TRAIN, root)
    readings = core.load_kind(cell).control(cell, 2 ** 31 + 23, "cpu")
    limits = cell.config["correctness"]
    for name in ("fp8", "half_batch"):
        assert any(v > limits[k] for k, v in readings[name]["checks"].items()), (name, readings[name])


def test_a_step_that_leaves_the_state_unchanged_fails(root, monkeypatch):
    from dexbotic_tpu_torch.exp import optim

    monkeypatch.setattr(optim.Optimizer, "step_", lambda self, params, grads: torch.zeros(()))
    result = run.run_cell(core.load_cell(TRAIN, root), 2 ** 31 + 25, 1.0, False, "cpu", 0.0)
    assert not ok(result)


@pytest.mark.parametrize("fault", list(control.FAULTS))
def test_an_answer_altered_where_it_is_produced_fails(root, fault):
    with control.planted(fault):
        result = run.run_cell(core.load_cell(SERVE, root), 2 ** 31 + 27, 2.0, False, "cpu", 0.0)
    assert not ok(result), [(c.name, c.value, c.limit) for c in result["checks"]]


def test_the_serving_control_fails(root):
    result = run.run_cell(core.load_cell(SERVE, root), 2 ** 31 + 29, 2.0, False, "cpu", 0.0,
                          quantize="int8")
    assert not ok(result), [(c.name, c.value, c.limit) for c in result["checks"]]


def test_training_spans_keep_the_k3_launch_count():
    """The port counts K3's launches on the entry that the span replaces."""
    import types

    from dexbotic_tpu_torch.ops import attention as attn_mod
    from vlabench.tests.vb_tiny import REPO
    from vlabench.trace import Spans

    real = attn_mod.flash_attention_bwd
    before = real.launches
    trainer = types.SimpleNamespace(optimizer=types.SimpleNamespace(step_=None))
    undo = core.load_part(REPO, "systems", "dm0").install_spans(trainer, Spans(True))
    attn_mod.flash_attention_bwd.launches += 1  # as the CUDA path counts a launch
    undo()
    assert attn_mod.flash_attention_bwd is real and real.launches == before + 1
