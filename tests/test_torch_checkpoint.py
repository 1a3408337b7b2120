"""The reference checkpoint loader on synthetic ``.pth`` files: port
``state_dict``s of RAFTGMA and ATDNVO written the way the reference
ships them (DataParallel ``module.`` prefixes, GMA's positional
``att.pos_emb.*`` and ATDNVO's unused ``polar_norm.*``) load back with
``strict=True``, tensor for tensor; and the JAX package's converter
(``tools/convert_torch_checkpoint.py``) reads the loader's output into
the variables the port's weights came from. The repository holds no
reference weights and none can be fetched.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from atdn_vslam_tpu.models.flow import RAFTGMA as JRAFTGMA
from atdn_vslam_tpu.models.odometry import ATDNVO as JATDNVO
from tools.convert_torch_checkpoint import convert_atdnvo, convert_gma

from atdn_vslam_torch.checkpoint import load_reference_checkpoint, reference_state_dict
from atdn_vslam_torch.convert import atdnvo_state_dict_from_jax, gma_state_dict_from_jax
from atdn_vslam_torch.models.flow.network import RAFTGMA
from atdn_vslam_torch.models.odometry import ATDNVO

torch.set_num_threads(1)

ODO_HW = (376, 1232)  # the converter tool fixes the 832-wide Linear of this size


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = np.asarray(v, np.float32)
    return out


@pytest.fixture(scope="module")
def weights():
    im = jnp.zeros((1, 64, 96, 3))
    flow_vars = jax.tree.map(np.array, JRAFTGMA(iters=1, use_pallas=False).init(jax.random.key(0), im, im))
    odo = JATDNVO()
    odo_vars = jax.tree.map(
        np.array, odo.init(jax.random.key(1), jnp.zeros((1, 1, *ODO_HW, 2)), odo.init_carry(1))
    )
    return {
        "gma": (flow_vars, gma_state_dict_from_jax(flow_vars), RAFTGMA(iters=1)),
        "atdnvo": (odo_vars, atdnvo_state_dict_from_jax(odo_vars, ODO_HW), ATDNVO(ODO_HW)),
    }


def _reference_file(path, sd, kind, wrap):
    """``sd`` as the reference ships it."""
    g = torch.Generator().manual_seed(0)
    ref = dict(sd)
    if kind == "gma":
        ref = {f"module.{k}": v for k, v in ref.items()}
        ref["module.att.pos_emb.rel_height.weight"] = torch.randn((2 * 47 - 1, 128), generator=g)
        ref["module.att.pos_emb.rel_width.weight"] = torch.randn((2 * 154 - 1, 128), generator=g)
    else:
        ref["polar_norm.weight"] = torch.ones(2)
        ref["polar_norm.bias"] = torch.zeros(2)
        ref["polar_norm.running_mean"] = torch.zeros(2)
        ref["polar_norm.running_var"] = torch.ones(2)
        ref["polar_norm.num_batches_tracked"] = torch.tensor(7)
    torch.save({"state_dict": ref} if wrap else ref, path)


@pytest.mark.parametrize("wrap", [False, True], ids=["state_dict", "checkpoint_dict"])
@pytest.mark.parametrize("kind", ["gma", "atdnvo"])
def test_reference_checkpoint_loads_strict(tmp_path, weights, kind, wrap):
    jax_vars, sd, model = weights[kind]
    path = tmp_path / f"{kind}.pth"
    _reference_file(path, sd, kind, wrap)
    loaded = load_reference_checkpoint(path)
    assert sorted(loaded) == sorted(sd)
    for key, value in sd.items():
        assert torch.equal(loaded[key], value), key
    model.load_state_dict(loaded, strict=True)
    # the JAX package's converter reads the same dict into the variables
    # the port's weights were made from
    back = _flat((convert_gma if kind == "gma" else convert_atdnvo)({k: v.numpy() for k, v in loaded.items()}))
    want = _flat(jax_vars)
    assert sorted(back) == sorted(want)
    for key, value in want.items():
        np.testing.assert_allclose(back[key], value, rtol=1e-6, atol=1e-7, err_msg=key)


def test_reference_state_dict_keeps_unprefixed_keys():
    sd = {"a.weight": torch.ones(1), "module.b.bias": torch.zeros(1), "att.pos_emb.x": torch.ones(1)}
    assert sorted(reference_state_dict(sd)) == ["a.weight", "b.bias"]
