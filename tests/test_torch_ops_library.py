"""Every kernel of the port is a ``torch.library`` custom op under the
namespace ``atdn``: ``torch.library.opcheck`` on each of the ten with
CPU inputs (its schema, its fake implementation against the real one,
and the op under AOT dispatch with dynamic shapes), and each op's CPU
implementation equal to the kernel's plain version (the same function,
so bitwise). Inputs are float32, small, and made from a seed with numpy.
"""

import numpy as np
import pytest
import torch

from atdn_vslam_torch.ops import attention as att
from atdn_vslam_torch.ops import corr_dot_tiled as tiled
from atdn_vslam_torch.ops import corr_lookup as corr
from atdn_vslam_torch.ops import corr_lookup_nlanes as nl
from atdn_vslam_torch.ops import corr_lookup_slab as slab
from atdn_vslam_torch.ops import norm

torch.set_num_threads(1)


def _t(rng, *shape, scale=1.0):
    return torch.from_numpy((rng.standard_normal(shape) * scale).astype(np.float32))


def _coords(rng, b, h, w):
    base = np.stack(np.meshgrid(np.arange(w), np.arange(h)), axis=-1)[None].astype(np.float32)
    return torch.from_numpy(base + rng.uniform(-3.0, 3.0, (b, h, w, 2)).astype(np.float32))


def _cases():
    rng = np.random.default_rng(0)
    h, w, d = 4, 5, 16
    n = h * w
    q, k, v = _t(rng, 1, n, d, scale=0.25), _t(rng, 1, n, d), _t(rng, 1, n, d)
    probs = att.attention_probs_spatial_plain(q, k, h, w, 1.0)
    regions = torch.from_numpy(rng.integers(0, 3, (1, n)).astype(np.int32))
    # a correlation pyramid of an 8 x 9 feature map against itself
    fh, fw, c = 8, 9, 16
    f1, f2 = _t(rng, 1, fh, fw, c), _t(rng, 1, fh, fw, c)
    pyramid = corr.build_corr_pyramid(f1, f2, 4)
    coords = _coords(rng, 1, fh, fw)
    vols = nl.build_corr_pyramid_nlanes(f1, f2, 4)[1:]
    padded, rows = slab.pad_pyramid_for_slab(pyramid)
    f1t = f1.reshape(1, fh * fw, c)
    f2_nchw = _t(rng, 1, c, fh, fw)
    return {
        "attention_probs": ((q, k, h, w, 1.0), att.attention_probs_spatial_plain),
        "apply_probs": ((probs, v), att.flash_apply_probs_plain),
        "flash_attend": ((q, k, v, 0.5), att.flash_attend_plain),
        "flash_attend_regions": ((q, k, v, regions, 0.5), att.flash_attend_regions_plain),
        "corr_dot": ((f1t, f2.reshape(1, fh * fw, c), 0.25, torch.float32), corr.corr_dot_rowmajor_plain),
        "corr_lookup": ((pyramid, coords, 4), corr.lookup_corr_pyramid_plain),
        "corr_lookup_nlanes": ((vols, coords.reshape(1, fh * fw, 2), 1, 4), nl.nlanes_lookup_levels_plain),
        "corr_lookup_slab": (
            (padded, coords, 4, list(rows)),
            lambda p, x, r, o: slab.lookup_corr_pyramid_slab_plain(p, x, r, orig_rows=tuple(o)),
        ),
        # f2 as the NHWC view of an NCHW map: any strides
        "corr_dot_tiled": ((f1t, f2_nchw.permute(0, 2, 3, 1), 0.25, torch.float32), tiled.corr_dot_tiled_plain),
        "instance_norm": ((f2_nchw * 2.0 + 1.0, True, 1e-5), norm.instance_norm_plain),
    }


CASES = _cases()


def test_every_kernel_is_an_atdn_op():
    registered = {n.split("::")[1] for n in torch._C._dispatch_get_all_op_names() if n.startswith("atdn::")}
    assert registered == set(CASES)
    for name in CASES:
        for key in ("CPU", "CUDA", "Meta"):
            assert torch._C._dispatch_has_kernel_for_dispatch_key(f"atdn::{name}", key), (name, key)


@pytest.mark.parametrize("name", sorted(CASES))
def test_opcheck_cpu(name):
    args, _ = CASES[name]
    result = torch.library.opcheck(getattr(torch.ops.atdn, name).default, args)
    assert set(result.values()) == {"SUCCESS"}, result


@pytest.mark.parametrize("name", sorted(CASES))
def test_op_cpu_is_the_plain_version(name):
    args, plain = CASES[name]
    got = getattr(torch.ops.atdn, name)(*args)
    want = plain(*args)
    assert got.shape == want.shape and got.dtype == want.dtype
    torch.testing.assert_close(got, want, rtol=0, atol=0, equal_nan=True)


@pytest.mark.parametrize("name", sorted(CASES))
def test_fake_matches_the_cpu_output(name):
    """The fake implementation's shape, type and strides, under the
    ``meta`` device, equal the CPU implementation's."""
    args, _ = CASES[name]
    meta = [[t.to("meta") for t in a] if isinstance(a, list) and a and isinstance(a[0], torch.Tensor)
            else a.to("meta") if isinstance(a, torch.Tensor) else a for a in args]
    op = getattr(torch.ops.atdn, name)
    got, want = op(*meta), op(*args)
    assert (got.shape, got.dtype, got.stride()) == (want.shape, want.dtype, want.stride())
