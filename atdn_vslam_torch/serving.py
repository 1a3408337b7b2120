"""Ahead-of-time export of the streaming step for deployment and serving.

Counterpart of ``atdn_vslam_tpu/serving.py``, name for name, on
``torch.export``: the streaming step (flow net in test mode, then ATDNVO,
then the pose update) is traced at fixed shapes into an
:class:`torch.export.ExportedProgram`, saved with ``torch.export.save``,
and loaded and run by a process that has no model code: a loaded
artifact needs ``torch`` and this package's ``ops`` modules, which
register the kernels as ``torch.library`` custom ops (``atdn::*``), and
never imports ``atdn_vslam_torch.models``.

  * :func:`make_stream_step`: one RGB frame in, flow and the accumulated
    pose out, the feature map and the LSTM state threaded through as
    explicit carries (each frame is feature-encoded once).
  * :func:`export_stream_step`, :func:`save_stream_step`,
    :func:`load_exported`: the export, with the weights baked into the
    artifact or left as call arguments for hot-swapping checkpoints;
    :func:`export_encoder` and :func:`zero_inputs_like` let a serving
    process bootstrap the carries from the artifacts alone.

Where the JAX package differs:

  * ``platforms`` and ``disabled_checks`` have no counterpart: an
    artifact holds the graph of the device it was exported on, and
    ``torch.export.passes.move_to_device_pass`` moves it to another (a
    card's artifact runs on the CPU that way, each ``atdn::`` op then
    taking its plain version). The kernels are custom ops with a stable
    schema, so there is no safety check to disable.
  * ``load_exported(..., jit=True)`` has no counterpart: PyTorch runs the
    loaded graph eagerly, and nothing is compiled at load time.
  * The process flags that choose TF32 are not part of a traced graph.
    The eager step runs every float32 convolution and matrix product in
    full float32 (``utils.helpers.full_float32``), so ``.call`` of a
    loaded artifact sets the same flags around each call.
"""

from __future__ import annotations

import copy
import os
from collections.abc import Callable, Mapping
from typing import Any

import torch
import torch.utils._pytree as pytree
from torch import nn
from torch.func import functional_call

# registers the eight kernels as atdn:: ops, which a loaded graph calls
from atdn_vslam_torch.ops import attention, corr_dot_tiled, corr_lookup, corr_lookup_nlanes, corr_lookup_slab  # noqa: F401
from atdn_vslam_torch.geometry.se3 import pose_to_matrix
from atdn_vslam_torch.utils.helpers import full_float32

State = Mapping[str, torch.Tensor]


def _call(model: nn.Module, state: State | None, *args, **kwargs):
    if state is None:
        return model(*args, **kwargs)
    # the reference's modules hold one batch norm under two names (norm3
    # and downsample.1): swap each tensor in once, under its first name,
    # or the swap back would leave the other name's tensor in the module
    own = {**dict(model.named_parameters()), **dict(model.named_buffers())}
    state = {k: v for k, v in state.items() if k in own}
    return functional_call(model, state, args, kwargs, tie_weights=False, strict=False)


def make_stream_step(
    flow_model: nn.Module, odo_model: nn.Module, bake: tuple[State, State] | None = None
) -> Callable:
    """The streaming per-frame step.

    Signature (``bake=None``)::

        step(flow_state, odo_state, im1, im2, fmap_prev, lstm_carry, pose)
            -> (pose, fmap2, lstm_carry, flow_up)

    with the models' weights as ``dict``s of tensors (their
    ``state_dict()``; ``torch.func.functional_call``). ``im1``, ``im2``
    are (H, W, 3) float32 RGB frames in [0, 255]; ``fmap_prev`` is the
    feature map of ``im1`` from the previous call (or
    :func:`encode_frame`); ``lstm_carry`` is ATDNVO's ((c1, h1), (c2,
    h2)); ``pose`` the (4, 4) float32 world pose, multiplied on the
    device, in float32, by the predicted relative transform (JAX
    ``serving.py:58-68``; the runtime instead chains float64 poses on the
    host). ``flow_up`` is (H, W, 2).

    With ``bake=(flow_state, odo_state)`` the weights are closed over and
    the step takes the five frame arguments; a state of None takes that
    model's own weights. The models run as they are (``.eval()`` for
    serving).
    """

    def _step(flow_state, odo_state, im1, im2, fmap_prev, lstm_carry, pose):
        (_, flow), fmap2 = _call(
            flow_model, flow_state, im1[None], im2[None], test_mode=True, fmap1=fmap_prev,
            return_features=True,
        )
        (rot, tr), lstm_carry = _call(odo_model, odo_state, flow[:, None], lstm_carry)
        pose = pose @ pose_to_matrix(rot[0, 0], tr[0, 0])
        return pose, fmap2, lstm_carry, flow[0]

    if bake is None:
        return _step
    flow_state, odo_state = bake

    def _baked(im1, im2, fmap_prev, lstm_carry, pose):
        return _step(flow_state, odo_state, im1, im2, fmap_prev, lstm_carry, pose)

    return _baked


def encode_frame(flow_model: nn.Module, flow_state: State | None, image: torch.Tensor) -> torch.Tensor:
    """Feature-encode one (H, W, 3) frame: the (1, H/8, W/8, 256) map that
    bootstraps the streaming carry. ``flow_state=None`` takes the
    model's own weights."""
    return _call(flow_model, flow_state, image[None], encode_only=True)


class _Traced(nn.Module):
    """A function as the module ``torch.export`` takes; the models are
    submodules, so their parameters and buffers are the artifact's."""

    def __init__(self, fn: Callable, *models: nn.Module):
        super().__init__()
        self.fn = fn
        self.models = nn.ModuleList(models)

    def forward(self, *args):
        return self.fn(*args)


def _device(model: nn.Module) -> torch.device:
    return next(model.parameters()).device


def _with_state(model: nn.Module, state: State | None) -> nn.Module:
    """``model``, or a copy holding ``state``: baked weights stay the
    artifact's parameters."""
    if state is None:
        return model
    model = copy.deepcopy(model)
    model.load_state_dict(state)
    return model


def export_stream_step(
    flow_model: nn.Module,
    odo_model: nn.Module,
    flow_state: State | None,
    odo_state: State | None,
    height: int,
    width: int,
    bake_weights: bool = True,
) -> torch.export.ExportedProgram:
    """Export the streaming step at a fixed frame size, on the models'
    device, under ``torch.no_grad()``.

    :param flow_state, odo_state: the weights (``state_dict``s); None
        takes each model's own.
    :param bake_weights: keep the weights in the artifact (self-contained).
        ``False`` makes them the first two call arguments, so a serving
        process can hot-swap checkpoints of the same shapes:
        ``call(flow_state, odo_state, im1, im2, fmap_prev, lstm_carry,
        pose)``.
    :return: the :class:`torch.export.ExportedProgram`; an artifact for
        another device: ``torch.export.passes.move_to_device_pass``.
    """
    device = _device(flow_model)
    image = torch.zeros((height, width, 3), device=device)
    with torch.no_grad():
        fmap = encode_frame(flow_model, flow_state, image)
        carry = pytree.tree_map(torch.zeros_like, odo_model.init_carry(1))  # four separate tensors
        args = (image, image.clone(), fmap, carry, torch.eye(4, device=device))
        if bake_weights:
            flow, odo = _with_state(flow_model, flow_state), _with_state(odo_model, odo_state)
            module = _Traced(make_stream_step(flow, odo, (None, None)), flow, odo)
        else:
            module = _Traced(make_stream_step(flow_model, odo_model))
            args = (  # plain dicts: an OrderedDict is another pytree node
                dict(flow_model.state_dict() if flow_state is None else flow_state),
                dict(odo_model.state_dict() if odo_state is None else odo_state),
                *args,
            )
        return torch.export.export(module, args)


def export_encoder(
    flow_model: nn.Module, flow_state: State | None, height: int, width: int
) -> torch.export.ExportedProgram:
    """Export the frame encoder (weights baked): ``call(image (H, W, 3)
    float32) -> (1, H/8, W/8, 256)``, the ``fmap_prev`` of the first
    streaming step, so a serving process needs no model code for it."""
    image = torch.zeros((height, width, 3), device=_device(flow_model))
    flow = _with_state(flow_model, flow_state)
    module = _Traced(lambda im: encode_frame(flow, None, im), flow)
    with torch.no_grad():
        return torch.export.export(module, (image,))


def zero_inputs_like(exported: torch.export.ExportedProgram, index: int) -> Any:
    """Zeros in the structure, shapes, types and device of positional
    argument ``index`` of the artifact, from its input spec and its
    placeholders' metadata: serving builds the initial LSTM carry
    (index 3, or 5 with the weights as arguments) with it, without the
    model classes. Every leaf is its own tensor."""
    names = set(exported.graph_signature.user_inputs)
    metas = [n.meta["val"] for n in exported.graph.nodes if n.op == "placeholder" and n.name in names]
    zeros = [torch.zeros(m.shape, dtype=m.dtype, device=m.device) for m in metas]
    args, _ = pytree.tree_unflatten(zeros, exported.call_spec.in_spec)
    return args[index]


def save_stream_step(exported: torch.export.ExportedProgram, path: str | os.PathLike) -> None:
    """Write the artifact to ``path`` (``torch.export.save``)."""
    torch.export.save(exported, path)


class Loaded:
    """A loaded artifact: ``.exported`` the
    :class:`torch.export.ExportedProgram`, ``.call(*args)`` its graph run
    under ``torch.no_grad()`` with TF32 off, as the eager step runs."""

    def __init__(self, exported: torch.export.ExportedProgram):
        self.exported = exported
        self._module = exported.module()

    def call(self, *args):
        with torch.no_grad(), full_float32():
            return self._module(*args)


def load_exported(path: str | os.PathLike) -> Loaded:
    """Load an artifact of :func:`save_stream_step` (``torch.export.load``).

    The loaded object needs ``torch`` and this package's ops, and no
    model code and no checkpoint (with ``bake_weights=True``). There is
    no ``jit`` flag as in the JAX package: the graph runs eagerly, op by
    op, with no compile step to cache."""
    return Loaded(torch.export.load(path))
