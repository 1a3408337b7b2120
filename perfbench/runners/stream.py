"""Closed-loop streaming odometry: one camera, batch 1, through
``SlamRuntime.__call__``.

Set-up builds the runtime from the configuration with seeded weights
made on the device, makes a pool of frames from the seed (a smooth
random texture panned by ``pan_px`` a frame) and streams the first
``warm_frames`` of the walk, which warms every shape the window uses.
The window then walks the pool forward and back, so the motion stays
continuous, handing each uint8 frame to the runtime and timing the call
to its returned global pose, until ``--seconds`` have passed; the
keyframe writer is flushed inside the window. Every run then streams
``device_frames`` more frames under the profiler recording the device
alone (the device's busy time a frame), and ``--trace 1`` streams
``profile_frames`` more, recording the host too.

The check samples ``check_samples`` frames of the window from the seed
(a reservoir, each frame's place decided before it runs), and the first
step of the stream. For each it keeps clones of what the program
produced, taken by forward hooks (``Capture``): every update's hidden
state in and delta flow out, the last hidden state and the returned
flow, ATDNVO's carry in and outputs; and the carry and the pose the
runtime returns. Once the window has closed the program is freed and
the float32 reference recomputes from the frames. Each flow-net number
is a mean gap from the reference, summed over the samples, in units of
the same sum for the reference computed with its operands rounded to
the type the configuration states (bf16, the "yardstick"); a sound
program reads about 1:

- ``first_update_units``: the first update's delta flow, the reference
  starting from the frames alone: the encoders, the volume, the
  attention, the motion encoder, the GRU and the flow head;
- ``update_units``: each update's delta flow, the reference starting
  from the program's own hidden state and flow before that update; the
  worst of the 12. From the second update on the lookup (K2) samples at
  fractional coordinates. Fewer or more updates than the configuration
  states read infinite;
- ``upsample_units``: the returned flow against the reference's convex
  upsampling of the program's last flow by the mask of its last hidden
  state;
- ``odometry_rel``: ATDNVO on the program's flow and carry in: rotation,
  translation and the new carry the runtime holds, each as a share of
  its largest value;
- ``pose_rel``: the motion between the program's returned global poses
  of the two frames against the reference's pose matrix (float64);
- ``carry_chain``: the carry the program handed to the step against the
  carry the runtime held after the step before (the zero carry for the
  first step): exact.

The reference follows the program update by update from the program's
own state, since random weights amplify rounding through the 12 updates
by a factor that differs from seed to seed (the flow after all of them
does not separate bf16 from fp8). ``first_update_units`` checks the
start from the frames alone, and ``upsample_units`` the end. ATDNVO
likewise runs from the program's carry; ``carry_chain`` and the first
step check that carry.
"""

from __future__ import annotations

import random
import shutil
import tempfile
import time

import numpy as np
import torch
import torch.nn.functional as F

from perfbench.core import flops as flop_count
from perfbench.core import trace as tracing
from perfbench.core.result import Run
from perfbench.core.weights import seeded_states
from perfbench.reference.atdnvo import ATDNVO as RefATDNVO
from perfbench.reference.atdnvo import pose_matrix
from perfbench.reference.gma import GMA
from perfbench.reference.precision import Precision, float32_only

#: the control's precision, one step below what the configuration states
LOWER = {"bfloat16": "fp8", "float32": "tf32"}
#: the reference's emulation of the precision the configuration states
STATED = {"bfloat16": "bf16", "float32": "float32"}


def synthetic_frames(n: int, hw: tuple[int, int], seed: int, dx: int = 3, dy: int = 1) -> list[np.ndarray]:
    """A smooth random texture seen by a camera panning ``dx`` px right and
    ``dy`` px down per frame (uint8, HWC)."""
    h, w = hw
    rng = np.random.default_rng(seed)
    pad_h, pad_w = max(n, -(-n * dy // 4)), max(n, -(-n * dx // 4))
    coarse = torch.from_numpy(rng.uniform(0, 255, (1, 3, h // 4 + pad_h, w // 4 + pad_w)).astype(np.float32))
    big = F.interpolate(coarse, scale_factor=4, mode="bilinear", align_corners=False)[0]
    big = big.permute(1, 2, 0).round().clamp(0, 255).to(torch.uint8).numpy()
    return [np.ascontiguousarray(big[dy * i : dy * i + h, dx * i : dx * i + w]) for i in range(n)]


def walk(i: int, pool: int) -> int:
    """Frame i of a walk forward and back over the pool."""
    k = i % (2 * pool - 2)
    return k if k < pool else 2 * pool - 2 - k


def templates(cfg: dict) -> list[dict]:
    """The flow net's and ATDNVO's state-dict shapes (meta tensors)."""
    with torch.device("meta"):
        return [flop_count.gma(cfg).state_dict(),
                RefATDNVO((cfg["image_height"], cfg["image_width"]), cfg["odometry"]["lstm_size"]).state_dict()]


def seeded_weights(cfg: dict, seed: int, device) -> list[dict]:
    a = cfg["assumed"]
    return seeded_states(templates(cfg), seed, device, fill=a["fill"], gain=a["gain"])


def port_config(cfg: dict, keyframes_path: str):
    from atdn_vslam_torch.config import Config, FlowNetConfig, OdometryModelConfig, SlamConfig

    f, o, s = cfg["flow"], cfg["odometry"], cfg["slam"]
    return Config(
        keyframes_path=keyframes_path,
        flow=FlowNetConfig(hidden_dim=f["hidden_dim"], context_dim=f["context_dim"], corr_levels=f["corr_levels"],
                           corr_radius=f["corr_radius"], num_heads=f["num_heads"], iters=f["iters"],
                           mixed_precision=f["compute_dtype"] == "bfloat16"),
        odometry=OdometryModelConfig(in_channels=o["in_channels"], compressor=o["compressor"],
                                     use_dropout=o["use_dropout"], use_layernorm=o["use_layernorm"],
                                     lstm_size=o["lstm_size"]),
        slam=SlamConfig(image_height=cfg["image_height"], image_width=cfg["image_width"],
                        rotation_threshold_deg=s["rotation_threshold_deg"],
                        translation_threshold=s["translation_threshold"], flow_warm_start=s["flow_warm_start"]),
    )


class Capture:
    """What the program produces in a frame, through forward hooks on its
    modules (the program is not edited): every frame counts the hooks'
    firings, and a frame armed with ``arm`` keeps clones of its flow, of
    each update's hidden state in and delta flow out and the last hidden
    state, and of ATDNVO's carry in and rotation and translation out. A sampled frame in which
    a hook never fired (a CUDA graph replays without them) stops the run:
    the check could not see it."""

    HOOKS = ("flow", "update", "odometry")

    def __init__(self, rt):
        self.kept = None
        self.last_low = None
        self.counts = dict.fromkeys(self.HOOKS, 0)
        self.handles = [rt.flow_model.update_block.register_forward_hook(self._update),
                        rt.flow_model.register_forward_hook(self._flow, with_kwargs=True),
                        rt.odometry_model.register_forward_hook(self._odo)]

    def arm(self, kept: dict | None) -> None:
        """Start a frame; ``kept`` (or None) takes this frame's clones."""
        self.counts = dict.fromkeys(self.HOOKS, 0)
        self.kept = kept
        if kept is not None:
            kept.update(net_in=[], delta=[])

    def _update(self, module, args, out):
        self.counts["update"] += 1
        if self.kept is not None:
            self.kept["net_in"].append(args[0].detach().clone())
            self.kept["delta"].append(out[1].detach().clone())
            self.kept["net_out"] = out[0].detach().clone()

    def _flow(self, module, args, kwargs, out):
        if kwargs.get("encode_only"):
            return
        self.counts["flow"] += 1
        (self.last_low, flow), _ = out
        if self.kept is not None:
            self.kept["flow"] = flow.detach().clone()

    def _odo(self, module, args, out):
        self.counts["odometry"] += 1
        if self.kept is not None:
            self.kept["carry_in"] = _clone(args[1])
            self.kept["motion"] = _clone(out[0])

    def seen(self, i: int) -> None:
        """Stop unless every hook fired in the kept frame ``i``."""
        missing = [name for name, n in self.counts.items() if n == 0]
        if missing:
            raise RuntimeError(f"perfbench: frame {i} was sampled for the check, but the program's "
                               f"{', '.join(missing)} hooks never fired in it; the check cannot see it")

    def remove(self):
        for h in self.handles:
            h.remove()


def _clone(x):
    if isinstance(x, torch.Tensor):
        return x.detach().clone()
    return type(x)(_clone(y) for y in x)


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def run(cell, seed: int, seconds: float, trace: bool, device: torch.device, t_start: float,
        control: str | None = None) -> Run:
    from atdn_vslam_torch.slam import SlamRuntime

    cfg, tr = cell.config, cell.traffic
    hw = (cfg["image_height"], cfg["image_width"])
    pool = tr["pool_frames"]
    kf_dir = tempfile.mkdtemp(prefix="perfbench-keyframes-")
    try:
        weights = seeded_weights(cfg, seed, device)
        rt = SlamRuntime(port_config(cfg, kf_dir), *weights, device=device)
        rt.start_odometry()
        frames = synthetic_frames(pool, hw, seed, *tr["pan_px"])
        cap = Capture(rt)
        rng = random.Random(seed)
        state = {"samples": [], "seen": 0}

        def slot(i: int, sample: bool) -> int | None:
            """Where frame i goes among the samples, decided before it runs: the
            first step always, then a reservoir of ``check_samples`` frames
            of the window drawn from the seed."""
            if i == 1:
                return 0
            if not sample:
                return None
            n, k = state["seen"], tr["check_samples"]
            state["seen"] += 1
            if n < k:
                return 1 + n
            j = rng.randrange(n + 1)
            return 1 + j if j < k else None

        def stream(i: int, sample: bool) -> None:
            where = slot(i, sample)
            kept = None
            if where is not None:
                # the carry the step before returned, as the runtime holds it
                kept = {"i": i, "carry_prev": _clone(rt._carry) if i > 1 else None,
                        "pose_prev": state.get("pose")}
            cap.arm(kept)
            pose = rt(frames[walk(i, pool)])
            if kept is not None:
                cap.seen(i)
                kept.update(pose=pose, carry_out=_clone(rt._carry))
                samples = state["samples"]
                if where < len(samples):
                    samples[where] = kept
                else:
                    samples.append(kept)
            state["pose"] = pose

        warm = tr["warm_frames"]
        for i in range(warm):
            stream(i, False)
        _sync(device)
        setup_s = time.perf_counter() - t_start

        times, i = [], warm
        t0 = time.perf_counter()
        deadline = t0 + seconds
        while True:
            ts = time.perf_counter()
            stream(i, True)
            now = time.perf_counter()
            times.append(now - ts)
            i += 1
            if now >= deadline:
                break
        rt.keyframes.flush()
        window_s = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0
        out = Run(cell=cell, setup_s=setup_s, units=len(times), samples=len(times), window_s=window_s,
                  unit_s=times, memory_peak_bytes=peak)
        out.extra["keyframes"] = len(rt.keyframes)
        out.extra["frames"] = i

        base = i
        out.device_slice = tracing.device_slice(lambda k: stream(base + k, False), tr["device_frames"], device)
        if trace:
            base += tr["device_frames"]
            out.trace = tracing.capture(lambda k: stream(base + k, False), tr["profile_frames"], device,
                                        {"flow_net": rt.flow_model, "atdnvo": rt.odometry_model},
                                        device_part=out.device_slice)
            if cap.last_low is not None:
                h8, w8 = hw[0] // 8, hw[1] // 8
                ys, xs = torch.meshgrid(torch.arange(h8), torch.arange(w8), indexing="ij")
                out.extra["k2_coords"] = torch.stack([xs, ys], -1).float() + cap.last_low[0].float().cpu()
            out.flops = flop_count.stream_frame(cfg)
        cap.remove()
        samples = state["samples"]
        rt.keyframes.flush()
        del rt, cap, state
        if device.type == "cuda":
            torch.cuda.empty_cache()
        out.checks = check(cfg, weights, frames, pool, samples, device, control)
        out.extra["checked_frames"] = [s["i"] for s in samples]
        return out
    finally:
        shutil.rmtree(kf_dir, ignore_errors=True)


def _mean_gap(got: torch.Tensor, ref: torch.Tensor) -> float:
    return float((got.double() - ref.double()).abs().mean())


def _rel(got: torch.Tensor, ref: torch.Tensor) -> float:
    return float((got.double() - ref.double()).abs().max() / ref.double().abs().max().clamp(min=1e-30))


@torch.no_grad()
def check(cfg: dict, weights: list[dict], frames, pool: int, samples: list[dict], device,
          control: str | None = None) -> dict[str, float]:
    """The numbers compared (module docstring). ``control`` puts the
    reference in the program's place, each net one step below the
    precision the configuration states (``LOWER``): its updates, flows
    and ATDNVO outputs (on the program's flow and carry) are compared
    instead of the program's."""
    hw = (cfg["image_height"], cfg["image_width"])
    f = cfg["flow"]

    def gma(precision: str):
        net = GMA(f["iters"], f["corr_levels"], f["corr_radius"], f["hidden_dim"], f["context_dim"],
                  f["fnet_dim"], f["dim_head"], Precision(precision)).to(device)
        net.load_state_dict(weights[0])
        return net.eval()

    def atdnvo(precision: str):
        odo = RefATDNVO(hw, cfg["odometry"]["lstm_size"], Precision(precision)).to(device)
        odo.load_state_dict(weights[1])
        return odo.eval()

    ref_flow, ref_odo = gma("float32"), atdnvo("float32")
    yardstick = gma(STATED[f["compute_dtype"]])
    low = (gma(LOWER[f["compute_dtype"]]), atdnvo(LOWER[cfg["odometry"]["compute_dtype"]])) if control else None
    iters = f["iters"]
    # sums over the samples: the program's gap from the reference, and the yardstick's
    first, upsampled = [0.0, 0.0], [0.0, 0.0]
    updates = [[0.0, 0.0] for _ in range(iters)]
    worst = {"odometry_rel": 0.0, "pose_rel": 0.0, "carry_chain": 0.0}

    def add(sums, got, ref, unit):
        sums[0] += _mean_gap(got, ref)
        sums[1] += _mean_gap(unit, ref)

    with float32_only():
        for s in samples:
            i = s["i"]
            im1, im2 = (torch.from_numpy(frames[walk(k, pool)]).to(device).float()[None] for k in (i - 1, i))
            prog = {k: s[k] for k in ("flow", "net_in", "delta", "net_out")}
            carry_in, (rot_p, tr_p), carry_p = s["carry_in"], s["motion"], s["carry_out"]
            rel_p = torch.from_numpy(np.linalg.inv(s["pose_prev"]) @ s["pose"])
            if low is not None:
                _, flow_c = low[0](im1, im2, record=True)
                prog = {"flow": flow_c, **low[0].trajectory}
                (rot_p, tr_p), carry_p = low[1](s["flow"].float()[:, None], carry_in)
                rel_p = pose_matrix(rot_p[0, 0].cpu(), tr_p[0, 0].cpu())
            ctx_r, ctx_y = ref_flow.prepare(im1, im2), yardstick.prepare(im1, im2)
            coords0 = ctx_r["coords0"]
            # the first update from the frames alone: the encoders, the volume, the attention
            add(first, prog["delta"][0], ref_flow.step(ctx_r, ctx_r["net"], coords0)[1],
                yardstick.step(ctx_y, ctx_y["net"], coords0)[1])
            # each update from the program's own hidden state and flow
            coords1 = coords0
            if len(prog["delta"]) != iters:
                updates[0][0] = float("inf")
            for k, (net_in, delta) in enumerate(zip(prog["net_in"][:iters], prog["delta"][:iters])):
                net_in = net_in.float()
                add(updates[k], delta, ref_flow.step(ctx_r, net_in, coords1)[1],
                    yardstick.step(ctx_y, net_in, coords1)[1])
                coords1 = coords1 + delta.float().permute(0, 2, 3, 1)
            # the returned flow from the program's last flow and hidden state
            flow_low, net_out = coords1 - coords0, prog["net_out"].float()
            add(upsampled, prog["flow"], ref_flow.upsample(flow_low, net_out),
                yardstick.upsample(flow_low, net_out))
            del ctx_r, ctx_y
            (rot_r, tr_r), carry_r = ref_odo(s["flow"].float()[:, None], carry_in)
            got = [rot_p, tr_p, *carry_p[0], *carry_p[1]]
            want = [rot_r, tr_r, *carry_r[0], *carry_r[1]]
            worst["odometry_rel"] = max(worst["odometry_rel"], *(_rel(a, b) for a, b in zip(got, want)))
            worst["pose_rel"] = max(worst["pose_rel"], _rel(rel_p, pose_matrix(rot_r[0, 0].cpu(), tr_r[0, 0].cpu())))
            expected = s["carry_prev"] if i > 1 else ref_odo.init_carry(1, device)
            for a, b in zip((*carry_in[0], *carry_in[1]), (*expected[0], *expected[1])):
                worst["carry_chain"] = max(worst["carry_chain"], float((a.float() - b.float()).abs().max()))

    def units(sums):
        return sums[0] / max(sums[1], 1e-30)

    return {"first_update_units": units(first), "update_units": max(units(u) for u in updates),
            "upsample_units": units(upsampled), **worst}
