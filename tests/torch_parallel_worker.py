"""One rank of the port's parallel paths on the CPU, for
``tests/test_torch_parallel.py``:

    python tests/torch_parallel_worker.py RANK WORLD PORT WORK_DIR

joins a gloo group of WORLD processes at ``localhost:PORT``, reads the
cases from ``WORK_DIR/inputs.pt``, runs each through the port's row- or
batch-split entry point and writes ``WORK_DIR/rank<RANK>.pt``. With a
fifth argument ``grid`` it runs only the odometry step with its
parameters split over the "model" ranks of a 2 x (WORLD / 2) mesh. It
imports torch and the port alone, never JAX.
"""

from __future__ import annotations

import dataclasses
import os
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from atdn_vslam_torch.config import LossConfig, MappingTrainConfig, MeshConfig  # noqa: E402
from atdn_vslam_torch.parallel import distributed, make_mesh  # noqa: E402

torch.set_num_threads(1)


def as_float64(model: torch.nn.Module) -> torch.nn.Module:
    """The module in float64, its compute types too."""
    model.double()
    for m in model.modules():
        if getattr(m, "dtype", None) == torch.float32:
            m.dtype = torch.float64
    return model


def flow_model(case: dict, regime: str):
    """RAFTGMA in float32 from the case's weights; ``regime`` "flash"
    lowers the token thresholds so the net attends in every iteration
    through K5's entry point."""
    from atdn_vslam_torch.models.flow.network import RAFTGMA
    from atdn_vslam_torch.ops import attention

    if regime == "flash":
        attention._MATERIALIZE_MAX_TOKENS = case["flash_tokens"]
        attention._FLASH_MIN_TOKENS = case["flash_tokens"]
    else:
        attention._MATERIALIZE_MAX_TOKENS, attention._FLASH_MIN_TOKENS = 8192, 16384
    model = RAFTGMA(iters=case["iters"])
    model.load_state_dict(case["state_dict"])
    return model.eval()


def run_flow(case: dict, mesh) -> dict:
    from atdn_vslam_torch.parallel import sharded_flow_infer

    out = {}
    for regime in ("materialize", "flash"):
        low, up = sharded_flow_infer(flow_model(case, regime), case["im1"], case["im2"], mesh)
        out[regime] = (low, up)
    flow_model(case, "materialize")  # the thresholds back
    return out


def run_attention(case: dict, mesh) -> dict:
    from atdn_vslam_torch.ops import attention

    h, w = case["h"], case["w"]
    lo, hi = distributed.band_bounds(h, mesh.model, mesh.model_index)
    q = case["q"][:, lo * w : hi * w]
    return {
        "probs": attention.sharded_flash_probs_spatial(q, case["k"], h, w, mesh=mesh),
        "attend": attention.sharded_flash_attend(q, case["k"], case["v"], mesh=mesh, n_rows=h, row_len=w),
        "apply": attention.sharded_flash_apply_probs(case["probs"][:, lo:hi], case["v"], mesh=mesh, h=h),
    }


def run_odometry(case: dict, mesh) -> dict:
    from atdn_vslam_torch.models.odometry import ATDNVO
    from atdn_vslam_torch.parallel import shard_batch
    from atdn_vslam_torch.training import odometry

    out = {}
    for dtype in (torch.float64, torch.float32):
        model = ATDNVO(case["hw"])
        model.load_state_dict(case["state_dict"])
        if dtype == torch.float64:
            as_float64(model)
        opt, sched = odometry.make_optimizer(model, case["train_cfg"], 1)
        state = odometry.OdometryTrainState(model, opt, sched)
        batch = shard_batch(mesh, tuple(x.to(dtype) for x in case["batch"]))
        metrics = odometry.train_step(state, *batch, LossConfig(alpha=case["alpha"]), mesh)
        out[str(dtype)] = _step_result(model, metrics)
    return out


def run_split_odometry(case: dict, mesh) -> dict:
    """The odometry step with the JAX rule's parameters split over the
    mesh's "model" ranks, from the case's whole weights (float32) or, with
    ``case["seed"]``, from ``init_state``'s seeded weights (float64 and
    float32). Each run keeps the first step's gathered gradients, metrics
    and statistics, the split parameters' local and whole sizes and their
    moments' sizes, and the dropout outputs' zeros; the float32 run takes
    ``case["steps"]`` steps in all and keeps the replicated parameters."""
    from atdn_vslam_torch.config import Config
    from atdn_vslam_torch.models.blocks import Dropout
    from atdn_vslam_torch.models.odometry import ATDNVO
    from atdn_vslam_torch.parallel import shard_batch, tensor_parallel
    from atdn_vslam_torch.parallel.mesh import model_parallel_sharding
    from atdn_vslam_torch.training import odometry

    out = {}
    for dtype in (torch.float64, torch.float32):
        model = ATDNVO(case["hw"], **case.get("opts", {}))
        if dtype == torch.float64:
            as_float64(model)
        sharding = model_parallel_sharding(mesh, model)
        if "seed" in case:
            state = odometry.init_state(model, case["train_cfg"], case["steps"], case["seed"], mesh, sharding)
        else:
            model.load_state_dict(case["state_dict"])
            tensor_parallel.shard_model(model, mesh, sharding)
            state = odometry.OdometryTrainState(model, *odometry.make_optimizer(model, case["train_cfg"], case["steps"]))
        masks = []
        for m in model.modules():
            if isinstance(m, Dropout):
                m.register_forward_hook(lambda mod, args, y: masks.append(y.detach() == 0))
        batch = shard_batch(mesh, tuple(x.to(dtype) for x in case["batch"]))
        loss_cfg = LossConfig(alpha=case["alpha"])
        metrics = odometry.train_step(state, *batch, loss_cfg, mesh)
        grads = {n: p.grad for n, p in model.named_parameters()}
        res = _step_result(model, metrics)
        res["grads"] = tensor_parallel.gather_split(model, grads)
        res["masks"] = masks
        res["split"] = {n: (model.get_parameter(n).numel(), res["grads"][n].numel(),
                            state.optimizer.state[model.get_parameter(n)]["exp_avg"].numel(),
                            state.optimizer.state[model.get_parameter(n)]["exp_avg_sq"].numel())
                        for n in tensor_parallel.model_splits(model)}
        res["sharding"] = {n: v is not None for n, v in sharding.items()}
        if "checkpoint_dir" in case and dtype == torch.float64:
            cfg = Config(checkpoint_dir=os.path.join(case["checkpoint_dir"], "split"))
            odometry.save_checkpoint(cfg, 1, state)
            res["whole_state"] = {k: v.clone() for k, v in tensor_parallel.gathered_state_dict(model).items()}
            res["whole_moments"] = tensor_parallel.gathered_optimizer_state(state.optimizer, model)["state"]
        if dtype == torch.float32:
            for _ in range(case["steps"] - 1):
                odometry.train_step(state, *batch, loss_cfg, mesh)
            splits = tensor_parallel.model_splits(model)
            res["replicated"] = {n: p.detach().clone() for n, p in model.named_parameters() if n not in splits}
        out[str(dtype)] = res
    return out


def run_loaded_split_step(case: dict, mesh) -> dict:
    """A one-process checkpoint (float64) loaded onto split ranks, then
    the next step: its gathered gradients and metrics."""
    from atdn_vslam_torch.config import Config
    from atdn_vslam_torch.models.odometry import ATDNVO
    from atdn_vslam_torch.parallel import shard_batch, tensor_parallel
    from atdn_vslam_torch.training import odometry

    model = as_float64(ATDNVO(case["hw"]))
    tensor_parallel.shard_model(model, mesh)
    state = odometry.OdometryTrainState(model, *odometry.make_optimizer(model, case["train_cfg"], case["steps"]))
    odometry.load_checkpoint(Config(checkpoint_dir=case["single_checkpoint_dir"]), 1, state)
    batch = shard_batch(mesh, tuple(x.double() for x in case["batch"]))
    metrics = odometry.train_step(state, *batch, LossConfig(alpha=case["alpha"]), mesh)
    res = _step_result(model, metrics)
    res["grads"] = tensor_parallel.gather_split(model, {n: p.grad for n, p in model.named_parameters()})
    res["step"] = state.step
    return res


def run_mapping(case: dict, mesh) -> dict:
    from atdn_vslam_torch.models.mapping import MappingVAE
    from atdn_vslam_torch.parallel import shard_batch
    from atdn_vslam_torch.training import mapping

    out = {}
    for dtype in (torch.float64, torch.float32):
        model = MappingVAE()
        model.load_state_dict(case["state_dict"])
        if dtype == torch.float64:
            as_float64(model)
        opt, sched = mapping.make_optimizer(model, MappingTrainConfig(epochs=1, batch_size=2, seed=0), 1)
        images, *factors = shard_batch(mesh, (case["images"], *case["factors"]))
        loss = mapping.train_step(model, opt, sched, images, tuple(factors), mesh)
        out[str(dtype)] = _step_result(model, {"loss": loss})
    return out


def run_flow_train(case: dict, mesh) -> dict:
    from atdn_vslam_torch.models.flow.network import RAFTGMA
    from atdn_vslam_torch.parallel import shard_batch
    from atdn_vslam_torch.training import flow

    model = RAFTGMA(iters=case["iters"])
    model.load_state_dict(case["state_dict"])
    as_float64(model)
    state = flow.init_state(model, *case["optimizer"], seed=None)
    batch = shard_batch(mesh, tuple(x.double() for x in case["batch"]))
    state, metrics = flow.train_step(state, *batch, gamma=case["gamma"], mesh=mesh)
    return _step_result(model, metrics)


def _step_result(model, metrics) -> dict:
    return {
        "metrics": {k: v for k, v in metrics.items() if isinstance(v, torch.Tensor)},
        "grads": {n: p.grad.clone() for n, p in model.named_parameters() if p.grad is not None},
        "stats": {k: v.clone() for k, v in model.state_dict().items() if "running" in k},
    }


def run_nearest(case: dict, mesh) -> dict:
    from atdn_vslam_torch.slam.keyframes import nearest_sharded

    return {name: nearest_sharded(mesh, case["embeddings"], code, "cpu") for name, code in case["codes"].items()}


def run_pose_graph(case: dict, mesh) -> dict:
    from atdn_vslam_torch.geometry.pose_graph import optimize_pose_graph_sharded

    return {
        solver: optimize_pose_graph_sharded(mesh, *case["graph"], iterations=case["iterations"], solver=solver)
        for solver in ("dense", "cg")
    }


def run_runtime(case: dict, mesh, rank: int) -> dict:
    """A cold start streams the frames, ``end_odometry`` trains the map
    and embeds the keyframes, then each query relocalises."""
    from atdn_vslam_torch.slam import SlamRuntime

    cfg = dataclasses.replace(case["config"], keyframes_path=os.path.join(case["dir"], f"kf{rank}"))
    rt = SlamRuntime(cfg, case["flow"], case["odometry"], device="cpu", mesh=mesh)
    rt.start_odometry()
    poses = np.stack([rt(f) for f in case["frames"]])
    rt.end_odometry()
    answers = [rt(f) for f in case["queries"]]
    return {"poses": poses, "answers": answers, "embeddings": rt.keyframes.embeddings.copy()}


def main(argv: list[str]) -> int:
    rank, world, port, work = int(argv[0]), int(argv[1]), int(argv[2]), argv[3]
    distributed.initialize(f"localhost:{port}", world, rank, backend="gloo", device="cpu")
    cases = torch.load(os.path.join(work, "inputs.pt"), weights_only=False)
    if argv[4:] == ["grid"]:
        grid = make_mesh(MeshConfig(data=2, model=world // 2))
        out = {name: run_split_odometry(case, grid) for name, case in cases.items()}
        out["mesh"] = {"shape": grid.shape, "data_index": grid.data_index, "model_index": grid.model_index}
        torch.save(out, os.path.join(work, f"rank{rank}.pt"))
        torch.distributed.destroy_process_group()
        return 0
    rows = make_mesh(MeshConfig(data=1, model=world))
    batch = make_mesh(MeshConfig(data=world, model=1))
    out = {
        "flow": run_flow(cases["flow"], rows),
        "attention": run_attention(cases["attention"], rows),
        "odometry": run_odometry(cases["odometry"], batch),
        "split_odometry": run_split_odometry(cases["split_odometry"], rows),
        "loaded_split_step": run_loaded_split_step(cases["split_odometry"], rows),
        "mapping": run_mapping(cases["mapping"], batch),
        "flow_train": run_flow_train(cases["flow_train"], batch),
        "nearest": run_nearest(cases["nearest"], batch),
        "pose_graph": run_pose_graph(cases["pose_graph"], batch),
        "runtime": run_runtime(cases["runtime"], batch, rank),
        "mesh": {"rows": rows.shape, "batch": batch.shape, "model_index": rows.model_index,
                 "data_index": batch.data_index},
    }
    torch.save(out, os.path.join(work, f"rank{rank}.pt"))
    torch.distributed.destroy_process_group()
    return 0


if __name__ == "__main__":
    raise SystemExit(main(sys.argv[1:]))
