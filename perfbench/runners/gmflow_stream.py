"""Closed-loop streaming odometry through GMFlow: one camera, batch 1,
through ``SlamRuntime.__call__`` with ``flow.arch: gmflow``.

The stream mix of ``runners/stream.py``, whose pieces it imports: the
pool of frames from the seed (a smooth random texture panned by
``pan_px`` a frame) walked forward and back, ``warm_frames`` streamed in
set-up, the window of ``--seconds`` in which each uint8 frame goes to the
runtime when the last pose has returned, the keyframe writer flushed in
the window, then ``device_frames`` more frames under the profiler
recording the device alone and, with ``--trace 1``, ``profile_frames``
recording the host too.

The check samples ``check_samples`` frames of the window from the seed
(a reservoir, each frame's place decided before it runs) and the first
step. For each it keeps clones of what the program produced, through
forward hooks (``Capture``): the transformer's two outputs, the matched
and the propagated flow, the returned flow, ATDNVO's carry in and
outputs, and the carry and pose the runtime returns. Once the window
has closed the program is freed and the float32 reference
(``reference/gmflow.py``) follows it stage by stage, each stage from
the program's own input:

- ``transformer_units``: the six blocks' output (both frames' features)
  from the frames: backbone, position encoding, transformer. A mean gap
  from the reference, summed over the samples, in units of the same sum
  for the reference with its operands rounded to the stated type (bf16,
  the yardstick); a sound program reads about 1;
- ``match_rel``: the matched flow from the program's features (float32
  in the configuration, so no yardstick: the largest gap over the
  largest flow, the worst sample);
- ``propagate_rel``: the propagated flow from the program's features and
  matched flow, the same way;
- ``upsample_units``: the returned flow from the program's propagated
  flow and features (the upsampler's mask and the convex combination),
  in yardstick units as ``transformer_units``;
- ``odometry_rel``, ``pose_rel``, ``carry_chain``: ATDNVO on the
  program's flow and carry, the pose, and the carry handed from step to
  step, as in ``runners/stream.py``.
"""

from __future__ import annotations

import random
import shutil
import tempfile
import time

import numpy as np
import torch

from perfbench.core import gmflow as work
from perfbench.core import trace as tracing
from perfbench.core.result import Run
from perfbench.core.weights import seeded_states
from perfbench.reference.atdnvo import ATDNVO as RefATDNVO
from perfbench.reference.atdnvo import pose_matrix
from perfbench.reference.precision import Precision, float32_only
from perfbench.runners.stream import LOWER, STATED, _clone, _mean_gap, _rel, _sync, synthetic_frames, walk

#: what the port's GMFlow computes; a configuration asking for anything else is refused
PUBLISHED = {"feature_channels": 128, "num_transformer_layers": 6, "ffn_dim_expansion": 4, "num_head": 1,
             "attention_type": "swin", "attn_splits": 2, "corr_radius": -1, "prop_radius": -1,
             "upsample_factor": 8, "padding_factor": 16, "matching_dtype": "float32"}


def templates(cfg: dict) -> list[dict]:
    with torch.device("meta"):
        return [work.reference(cfg).state_dict(),
                RefATDNVO((cfg["image_height"], cfg["image_width"]), cfg["odometry"]["lstm_size"]).state_dict()]


def seeded_weights(cfg: dict, seed: int, device) -> list[dict]:
    a = cfg["assumed"]
    return seeded_states(templates(cfg), seed, device, fill=a["fill"], gain=a["gain"])


def port_config(cfg: dict, keyframes_path: str):
    from atdn_vslam_torch.config import Config, FlowNetConfig, OdometryModelConfig, SlamConfig

    f, o, s = cfg["flow"], cfg["odometry"], cfg["slam"]
    off = {k: f.get(k) for k, v in PUBLISHED.items() if f.get(k) != v}
    if off:
        raise ValueError(f"the port's GMFlow computes {PUBLISHED}; the configuration asks for {off}")
    return Config(
        keyframes_path=keyframes_path,
        flow=FlowNetConfig(arch=f["arch"], mixed_precision=f["compute_dtype"] == "bfloat16"),
        odometry=OdometryModelConfig(in_channels=o["in_channels"], compressor=o["compressor"],
                                     use_dropout=o["use_dropout"], use_layernorm=o["use_layernorm"],
                                     lstm_size=o["lstm_size"]),
        slam=SlamConfig(image_height=cfg["image_height"], image_width=cfg["image_width"],
                        rotation_threshold_deg=s["rotation_threshold_deg"],
                        translation_threshold=s["translation_threshold"], flow_warm_start=s["flow_warm_start"]),
    )


class Capture:
    """What the program produces in a frame, through forward hooks on its
    modules (the program is not edited); as ``runners/stream.py``'s: a
    sampled frame in which a hook never fired stops the run."""

    HOOKS = ("flow", "transformer", "matching", "propagation", "odometry")

    def __init__(self, rt):
        fm = rt.flow_model
        self.kept = None
        self.counts = dict.fromkeys(self.HOOKS, 0)
        self.handles = [fm.transformer.register_forward_hook(self._keep("transformer", "features")),
                        fm.matching.register_forward_hook(self._keep("matching", "matched")),
                        fm.feature_flow_attn.register_forward_hook(self._keep("propagation", "propagated")),
                        fm.register_forward_hook(self._flow, with_kwargs=True),
                        rt.odometry_model.register_forward_hook(self._odo)]

    def arm(self, kept: dict | None) -> None:
        self.counts = dict.fromkeys(self.HOOKS, 0)
        self.kept = kept

    def _keep(self, hook: str, key: str):
        def keep(module, args, out):
            self.counts[hook] += 1
            if self.kept is not None:
                self.kept[key] = _clone(out)
        return keep

    def _flow(self, module, args, kwargs, out):
        if kwargs.get("encode_only"):
            return
        self.counts["flow"] += 1
        if self.kept is not None:
            self.kept["flow"] = out[0][1].detach().clone()

    def _odo(self, module, args, out):
        self.counts["odometry"] += 1
        if self.kept is not None:
            self.kept["carry_in"] = _clone(args[1])
            self.kept["motion"] = _clone(out[0])

    def seen(self, i: int) -> None:
        missing = [name for name, n in self.counts.items() if n == 0]
        if missing:
            raise RuntimeError(f"perfbench: frame {i} was sampled for the check, but the program's "
                               f"{', '.join(missing)} hooks never fired in it; the check cannot see it")

    def remove(self):
        for h in self.handles:
            h.remove()


def run(cell, seed: int, seconds: float, trace: bool, device: torch.device, t_start: float,
        control: str | None = None) -> Run:
    from atdn_vslam_torch.slam import SlamRuntime

    cfg, tr = cell.config, cell.traffic
    hw = (cfg["image_height"], cfg["image_width"])
    pool = tr["pool_frames"]
    kf_dir = tempfile.mkdtemp(prefix="perfbench-keyframes-")
    try:
        config = port_config(cfg, kf_dir)
        weights = seeded_weights(cfg, seed, device)
        rt = SlamRuntime(config, *weights, device=device)
        rt.start_odometry()
        frames = synthetic_frames(pool, hw, seed, *tr["pan_px"])
        cap = Capture(rt)
        rng = random.Random(seed)
        state = {"samples": [], "seen": 0}

        def slot(i: int, sample: bool) -> int | None:
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
            out.flops = work.stream_frame(cfg)
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


def _nchw(x: torch.Tensor) -> torch.Tensor:
    return x.float().permute(0, 3, 1, 2)


@torch.no_grad()
def check(cfg: dict, weights: list[dict], frames, pool: int, samples: list[dict], device,
          control: str | None = None) -> dict[str, float]:
    """The numbers compared (module docstring). ``control`` puts the
    reference in the program's place one step below the stated precision
    (``LOWER``): fp8 for the bf16 stages, TF32 for the matching, the
    propagation and ATDNVO."""
    hw = (cfg["image_height"], cfg["image_width"])
    f = cfg["flow"]

    def gmflow(precision: str, matching: str):
        net = work.reference(cfg, precision, matching).to(device)
        net.load_state_dict(weights[0])
        return net.eval()

    def atdnvo(precision: str):
        odo = RefATDNVO(hw, cfg["odometry"]["lstm_size"], Precision(precision)).to(device)
        odo.load_state_dict(weights[1])
        return odo.eval()

    ref, ref_odo = gmflow("float32", "float32"), atdnvo("float32")
    yardstick = gmflow(STATED[f["compute_dtype"]], STATED[f["matching_dtype"]])
    low = None
    if control:
        low = (gmflow(LOWER[f["compute_dtype"]], LOWER[f["matching_dtype"]]),
               atdnvo(LOWER[cfg["odometry"]["compute_dtype"]]))
    transformer, upsampled = [0.0, 0.0], [0.0, 0.0]
    worst = {"match_rel": 0.0, "propagate_rel": 0.0, "odometry_rel": 0.0, "pose_rel": 0.0, "carry_chain": 0.0}

    def add(sums, got, ref_, unit):
        sums[0] += _mean_gap(got, ref_)
        sums[1] += _mean_gap(unit, ref_)

    with float32_only():
        for s in samples:
            i = s["i"]
            im1, im2 = (torch.from_numpy(frames[walk(k, pool)]).to(device).float()[None] for k in (i - 1, i))
            feats = tuple(_nchw(x) for x in s["features"])
            matched, propagated, flow = _nchw(s["matched"]), _nchw(s["propagated"]), s["flow"].float()
            carry_in, (rot_p, tr_p), carry_p = s["carry_in"], s["motion"], s["carry_out"]
            rel_p = torch.from_numpy(np.linalg.inv(s["pose_prev"]) @ s["pose"])
            if low is not None:
                net = low[0]
                feats = net.transform(*net.features(im1, im2))
                matched = net.match(*feats)
                propagated = net.propagate(feats[0], matched)
                flow = net.upsample(propagated, feats[0])[:, : hw[0], : hw[1]]
                (rot_p, tr_p), carry_p = low[1](s["flow"].float()[:, None], carry_in)
                rel_p = pose_matrix(rot_p[0, 0].cpu(), tr_p[0, 0].cpu())
            # the blocks' output from the frames
            add(transformer, torch.cat(feats), torch.cat(ref.transform(*ref.features(im1, im2))),
                torch.cat(yardstick.transform(*yardstick.features(im1, im2))))
            # matching and propagation, each from the program's own input
            worst["match_rel"] = max(worst["match_rel"], _rel(matched, ref.match(*feats)))
            worst["propagate_rel"] = max(worst["propagate_rel"], _rel(propagated, ref.propagate(feats[0], matched)))
            # the returned flow from the program's propagated flow and features
            add(upsampled, flow, ref.upsample(propagated, feats[0])[:, : hw[0], : hw[1]],
                yardstick.upsample(propagated, feats[0])[:, : hw[0], : hw[1]])
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

    return {"transformer_units": units(transformer), "match_rel": worst["match_rel"],
            "propagate_rel": worst["propagate_rel"], "upsample_units": units(upsampled),
            "odometry_rel": worst["odometry_rel"], "pose_rel": worst["pose_rel"],
            "carry_chain": worst["carry_chain"]}
