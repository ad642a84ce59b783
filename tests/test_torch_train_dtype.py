"""The Trainer's bf16 dtype rule against the JAX Trainer's, on every model
family the Trainer trains, on the CPU.

The JAX Trainer (``bf16=True``) casts every fp32 leaf of its tree with ndim
>= 2 to bf16 (``dexbotic_tpu/exp/trainer.py:99-105``).  The JAX tree stacks
a decoder's, a ViT's and a DiT's layers on a leading axis, so their norm
scales and biases are [L, D] leaves there and train in bf16; a Python list of
layers (OFT's MLPResNet ``blocks``, MemVLA's ``retrieval``) keeps its 1-D
leaves fp32.  Each case builds the tiny JAX tree and the port's model from it
(``utils/bridge.load_jax_params``), hands the tree to the JAX Trainer and
the model to the port's, and holds every port parameter to the dtype the
JAX Trainer gave the leaf it was carried from (``utils/bridge.port_arrays``).
"""

import dataclasses

import jax
import pytest
import torch

from dexbotic_tpu.exp import optim as joptim
from dexbotic_tpu.exp import trainer as jtrainer
from dexbotic_tpu.models import cogact as jcogact
from dexbotic_tpu.models import discrete_vla as jdv
from dexbotic_tpu.models import flow_vla as jflow
from dexbotic_tpu.models import memvla as jmem
from dexbotic_tpu.models import muvla as jmu
from dexbotic_tpu.models import navila as jnav
from dexbotic_tpu.models import oft as joft
from dexbotic_tpu.models import presets as jpresets
from dexbotic_tpu.models import vlm as jvlm
from dexbotic_tpu_torch.exp import optim as toptim
from dexbotic_tpu_torch.exp import trainer as ttrainer
from dexbotic_tpu_torch.models import cogact as tcogact
from dexbotic_tpu_torch.models import discrete_vla as tdv
from dexbotic_tpu_torch.models import flow_vla as tflow
from dexbotic_tpu_torch.models import memvla as tmem
from dexbotic_tpu_torch.models import muvla as tmu
from dexbotic_tpu_torch.models import navila as tnav
from dexbotic_tpu_torch.models import oft as toft
from dexbotic_tpu_torch.models import presets as tpresets
from dexbotic_tpu_torch.models import vlm as tvlm
from dexbotic_tpu_torch.utils.bridge import load_jax_params, port_arrays

torch.set_num_threads(2)


def _vlm(mod, presets, llm=None):
    return mod.VLMConfig(llm=llm or presets.LLM_TEST, vit=presets.VIT_TEST,
                         projector_type="mlp2x_gelu")


def _cogact(moe=False):
    """CogACT (and the hybrid exp's model, the same tree); ``moe`` swaps the
    decoder's FFN for 4 experts (``nn/moe.py``), as the mesh's expert axis
    trains it."""
    out = []
    for m, v, p in ((jcogact, jvlm, jpresets), (tcogact, tvlm, tpresets)):
        llm = dataclasses.replace(p.LLM_TEST, moe_num_experts=4) if moe else p.LLM_TEST
        out.append(m.CogActConfig(vlm=_vlm(v, p, llm=llm), action_model_type="DiT-S",
                                  action_dim=7, chunk_size=4))
    return out[0], jcogact.init_cogact, out[1], tcogact.build_cogact


def _flow(kind):
    """π0, π0.5 (adaRMS expert), DM0 and DM0-Prog (qk-norm in both streams)."""
    out = []
    for m, p in ((jflow, jpresets), (tflow, tpresets)):
        expert = p.EXPERT_TEST_ADARMS if kind == "pi05" else p.EXPERT_TEST
        qk = kind.startswith("dm0")
        out.append(getattr(m, f"{kind}_config")(
            dataclasses.replace(p.LLM_TEST, qk_norm=qk), dataclasses.replace(expert, qk_norm=qk),
            p.VIT_TEST, action_dim=8, chunk_size=5, projector_type="linear"))
    return out[0], jflow.init_flow_vla, out[1], tflow.build_flow_vla


def _oft(head):
    out = [m.OFTConfig(vlm=_vlm(v, p), action_model_type=head, action_dim=3, chunk_size=4,
                       num_bins=64, use_proprio=True, proprio_dim=5)
           for m, v, p in ((joft, jvlm, jpresets), (toft, tvlm, tpresets))]
    return out[0], joft.init_oft, out[1], toft.build_oft


def _memvla():
    out = [m.MemVLAConfig(vlm=_vlm(v, p), action_model_type="DiT-S", action_dim=3, chunk_size=4,
                          per_token_size=16, mem_length=3, repeated_diffusion_steps=2)
           for m, v, p in ((jmem, jvlm, jpresets), (tmem, tvlm, tpresets))]
    return out[0], jmem.init_memvla, out[1], tmem.build_memvla


def _navila():
    """NaVILA: a 3 x 3 patch grid for ``mlp_downsample``'s 2 x 2 blocks."""
    out = [m.NaVILAConfig(vlm=m_vlm.VLMConfig(
        llm=p.LLM_TEST, vit=dataclasses.replace(p.VIT_TEST, image_size=42),
        projector_type="mlp_downsample"))
        for m, m_vlm, p in ((jnav, jvlm, jpresets), (tnav, tvlm, tpresets))]
    return out[0], jnav.init_navila, out[1], tnav.build_navila


def _discrete():
    out = [m.DiscreteVLAConfig(vlm=_vlm(v, p)) for m, v, p in ((jdv, jvlm, jpresets),
                                                                (tdv, tvlm, tpresets))]
    return out[0], jdv.init_discrete_vla, out[1], tdv.build_discrete_vla


def _muvla():
    out = [m.MUVLAConfig(vlm=_vlm(v, p), obs_vit=p.VIT_TEST, inter_dim=32, num_history_queries=6,
                         fuse_heads=4)
           for m, v, p in ((jmu, jvlm, jpresets), (tmu, tvlm, tpresets))]
    return out[0], jmu.init_muvla, out[1], tmu.build_muvla


FAMILIES = {
    "cogact": _cogact, "cogact_moe": lambda: _cogact(moe=True),
    "pi0": lambda: _flow("pi0"), "pi05": lambda: _flow("pi05"), "dm0": lambda: _flow("dm0"),
    "dm0_prog": lambda: _flow("dm0_prog"),
    "oft_l1": lambda: _oft("L1"), "oft_diffusion": lambda: _oft("Diffusion"),
    "oft_discrete": lambda: _oft("Discrete"),
    "memvla": _memvla, "navila": _navila, "discrete_vla": _discrete, "muvla": _muvla,
}


def _loss(*_):  # never called: the rule is applied when a Trainer is made
    raise AssertionError


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_trainer_bf16_rule_matches_jax(tmp_path, family):
    jcfg, jinit, tcfg, tbuild = FAMILIES[family]()
    tree = jax.device_get(jinit(jax.random.PRNGKey(0), jcfg))
    model = tbuild(tcfg, "cpu")
    load_jax_params(model, tree)

    jt = jtrainer.Trainer(_loss, tree, jtrainer.TrainerConfig(
        output_dir=str(tmp_path / "jax"), mesh_data=1, bf16=True, resume=False),
        joptim.OptimizerConfig())
    ttrainer.Trainer(_loss, model, ttrainer.TrainerConfig(
        output_dir=str(tmp_path / "port"), bf16=True, resume=False), toptim.OptimizerConfig())

    params = dict(model.named_parameters())
    want = {name: str(val.dtype) for name, val, _ in port_arrays(jax.device_get(jt.params))}
    assert want.keys() == params.keys()
    got = {name: str(p.dtype).removeprefix("torch.") for name, p in params.items()}
    wrong = {n: (got[n], want[n]) for n in want if got[n] != want[n]}
    assert not wrong, f"{len(wrong)} parameters (port, JAX): {dict(list(wrong.items())[:8])}"
    # the rule reaches the 1-D leaves of every stacked layer list, and JAX's
    # Python lists keep theirs fp32
    stacked_1d = [n for n, p in params.items() if p.ndim == 1 and ".layers.0." in n]
    assert stacked_1d and all(got[n] == "bfloat16" for n in stacked_1d)
    assert {"bfloat16", "float32"} <= set(want.values())
