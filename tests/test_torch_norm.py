"""K6, the flow encoders' instance norm with the ReLU after it
(``ops/norm.py``), on the CPU: its plain version against the chain it
replaces (a float32 copy, ``F.instance_norm``, the cast back, ``F.relu``),
``extractor.InstanceNorm`` on the CPU and under autograd bitwise that
chain, the encoders' 13 fused ReLUs, the wrapper's refusals, and the
cluster size the wrapper picks from a shape. The kernel itself is held
to the plain version on the card (``tests/test_torch_cuda.py``).
"""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from atdn_vslam_torch.models.flow import extractor, gmflow
from atdn_vslam_torch.ops import norm

torch.set_num_threads(1)

DTYPES = [torch.bfloat16, torch.float32, torch.float64]
# one bf16 ulp (2^-8 of the value, at most 2^-7) with a floor for values
# near zero; float32 and float64 differ by the order of the moments' sums
TOL = {torch.bfloat16: {"rtol": 2.0**-7, "atol": 1e-5}, torch.float32: {"rtol": 1e-5, "atol": 1e-6},
       torch.float64: {"rtol": 1e-12, "atol": 1e-12}}


def _x(shape, dtype, seed=0):
    """A convolution output's look: per channel an offset and a scale."""
    rng = np.random.default_rng(seed)
    c = shape[1]
    x = rng.normal(size=shape) * rng.uniform(0.5, 3.0, (1, c, 1, 1)) + rng.normal(size=(1, c, 1, 1)) * 2
    return torch.from_numpy(x).to(dtype)


def _chain(x, relu, eps=1e-5):
    """The encoders' norm before K6: float32 (float64) copy, instance norm,
    the cast back, then the ReLU."""
    y = F.instance_norm(x.to(torch.promote_types(x.dtype, torch.float32)), eps=eps).to(x.dtype)
    return F.relu(y) if relu else y


@pytest.mark.parametrize("dtype", DTYPES, ids=["bf16", "f32", "f64"])
@pytest.mark.parametrize("relu", [True, False], ids=["relu", "norm"])
@pytest.mark.parametrize("shape", [(1, 3, 7, 9), (2, 4, 5, 13), (1, 5, 1, 3), (2, 2, 31, 17), (1, 2, 47, 154)])
def test_plain_version_is_the_chain(shape, relu, dtype):
    x = _x(shape, dtype)
    got = norm.instance_norm_plain(x, relu)
    want = _chain(x, relu)
    assert got.dtype == dtype and got.shape == x.shape
    torch.testing.assert_close(got.double(), want.double(), **TOL[dtype])
    if relu:
        assert bool((got >= 0).all())


@pytest.mark.parametrize("dtype", DTYPES, ids=["bf16", "f32", "f64"])
@pytest.mark.parametrize("relu", [True, False], ids=["relu", "norm"])
@pytest.mark.parametrize("grad", [False, True], ids=["no_grad", "grad"])
def test_module_on_the_cpu_is_the_chain_bitwise(grad, relu, dtype):
    """The module's CPU path, and the path of an input autograd records
    (flow training), is the chain itself: the same bits forward and
    backward."""
    x = _x((2, 3, 9, 11), dtype, seed=1).requires_grad_(grad)
    got = extractor.InstanceNorm(relu=relu)(x)
    want = _chain(x, relu)
    assert torch.equal(got, want)
    if grad:
        cot = _x((2, 3, 9, 11), dtype, seed=2)
        (g_got,) = torch.autograd.grad(got, x, cot)
        (g_want,) = torch.autograd.grad(want, x, cot)
        assert torch.equal(g_got, g_want)


def test_nan_stays_nan():
    """A NaN plane stays NaN through the ReLU, as ``F.relu`` keeps it."""
    x = _x((1, 2, 4, 5), torch.float32)
    x[0, 1, 2, 3] = float("nan")
    got = norm.instance_norm_plain(x, True)
    assert bool(got[0, 1].isnan().all()) and not bool(got[0, 0].isnan().any())


@pytest.mark.parametrize("encoder", ["gma_fnet", "gma_cnet", "gmflow"])
def test_encoders_fuse_the_relu_after_13_of_15_norms(encoder):
    """Each encoder's stem and every residual block's norm1 and norm2
    take the ReLU after them; the downsample branch's norm3 does not. The
    context encoder's batch norms are built as before."""
    model = {"gma_fnet": lambda: extractor.BasicEncoder(256, "instance"),
             "gma_cnet": lambda: extractor.BasicEncoder(256, "batch"),
             "gmflow": lambda: gmflow.CNNEncoder(128)}[encoder]()
    norms = {n: m for n, m in model.named_modules() if isinstance(m, (extractor.InstanceNorm, extractor.BatchNorm))}
    names = {n.replace("downsample.1", "norm3") for n in norms}
    assert len(names) == 15
    if encoder == "gma_cnet":
        assert all(type(m) is extractor.BatchNorm for m in norms.values())
        return
    fused = {n for n, m in norms.items() if m.relu}
    assert len(fused) == 13 and all(n.split(".")[-1] in ("norm1", "norm2") for n in fused)


def test_wrapper_refuses_autograd_and_other_devices():
    """Off the CPU the wrapper launches K6 or raises: an input that
    requires grad (K6 has no backward), a device with no kernel."""
    x = torch.empty((1, 2, 3, 4), device="meta")
    with pytest.raises(RuntimeError, match="no backward"):
        norm.instance_norm(x.requires_grad_(True))
    with pytest.raises(RuntimeError, match="no kernel"):
        norm.instance_norm(torch.empty((1, 2, 3, 4), device="meta"))
    with torch.no_grad():
        with pytest.raises(RuntimeError, match="no kernel"):
            norm.instance_norm(x)


def test_op_fake_gives_the_shape():
    """Under the ``meta`` device (the fake implementation ``torch.export``
    traces) the op returns a contiguous tensor of the input's shape and type."""
    x = torch.empty((2, 64, 47, 154), device="meta", dtype=torch.bfloat16)
    y = torch.ops.atdn.instance_norm(x, True, 1e-5)
    assert (y.shape, y.dtype, y.device.type) == (x.shape, x.dtype, "meta") and y.is_contiguous()


SMS = 132
# the flow encoders' planes: GMA at KITTI (376x1232) one frame and a pair,
# GMFlow's padded KITTI (384x1232), Cityscapes (1024x2048)
SHAPES = {
    "kitti_half": (64, 188 * 616), "kitti_quarter": (96, 94 * 308), "kitti_eighth": (128, 47 * 154),
    "kitti_pair_half": (128, 188 * 616), "kitti_pair_eighth": (256, 47 * 154),
    "gmflow_half": (64, 192 * 616), "gmflow_eighth": (128, 48 * 154),
    "city_half": (64, 512 * 1024), "city_quarter": (96, 256 * 512), "city_eighth": (128, 128 * 256),
    "tiny": (6, 35), "one_plane": (1, 4096), "huge": (2, 4096 * 4096),
}


@pytest.mark.parametrize("itemsize", [2, 4], ids=["bf16", "f32"])
@pytest.mark.parametrize("name", sorted(SHAPES))
def test_plan_fits_shared_memory_and_fills_the_card(name, itemsize):
    """Clustered: 1-16 blocks a plane, each slice (with its alignment) in
    the budget, at least two blocks per SM unless slices would fall under
    a vector a thread; every smaller cluster would overflow the budget
    or leave SMs short. Otherwise two-pass, 1-256 slices."""
    planes, n = SHAPES[name]
    k, two_pass = norm._plan(planes, n, itemsize, SMS)
    vec = 16 // itemsize

    def fits(j):
        return (-(-n // j) + 2 * vec) * itemsize <= norm._SLICE_BYTES

    if two_pass:
        assert not fits(16) and 1 <= k <= 256 and planes * k >= min(2 * SMS, planes * 256)
        return
    assert 1 <= k <= 16 and fits(k)
    filled = planes * k >= 2 * SMS or -(-n // k) <= norm._THREADS * vec or k == 16
    assert filled
    assert k == 1 or not fits(k - 1) or planes * (k - 1) < 2 * SMS


def test_plan_at_the_stream_cells_shapes():
    """The cluster sizes of the stream cells' norms (bf16, 132 SMs)."""
    got = {name: norm._plan(*SHAPES[name], 2, SMS) for name in SHAPES}
    assert got["kitti_half"] == (5, False) and got["kitti_quarter"] == (3, False)
    assert got["kitti_eighth"] == (3, False) and got["gmflow_half"] == (5, False)
    assert got["city_half"] == (11, False) and got["huge"][1]
