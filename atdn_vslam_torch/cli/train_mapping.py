"""MappingVAE training on a keyframe store, the counterpart of the JAX
package's ``cli/train_mapping.py`` (the loop is the runtime's
``end_odometry`` map building, ref: neural_slam.py:305-352).

Loads the store's keyframes, trains the map, and writes the map and the
keyframe embeddings back into the store: the map to the file the
runtime's relocalization warm start reads (``mapping_variables.pt``),
so that ``SlamRuntime(..., start_mode="relocalization")`` starts from a
map trained here.

Usage:
  python -m atdn_vslam_torch.cli.train_mapping --keyframes keyframes \\
      [--config configs/kitti.yaml --epochs 50 --batch-size 16 --device cuda]
"""

from __future__ import annotations

import argparse
import dataclasses

import numpy as np

from atdn_vslam_torch.config import load_config
from atdn_vslam_torch.models.factory import build_mapping_model
from atdn_vslam_torch.slam.keyframes import KeyframeStore
from atdn_vslam_torch.slam.runtime import embed_keyframes, save_map
from atdn_vslam_torch.training.mapping import train_mapping
from atdn_vslam_torch.utils.helpers import log


def main(argv: list[str] | None = None) -> int:
    p = argparse.ArgumentParser(description="MappingVAE training")
    p.add_argument("--config", type=str, default=None)
    p.add_argument("--keyframes", type=str, default=None)
    p.add_argument("--epochs", type=int, default=None)
    p.add_argument("--batch-size", type=int, default=None)
    p.add_argument("--lr", type=float, default=None)
    p.add_argument("--device", type=str, default="cuda")
    args = p.parse_args(argv)

    config = load_config(args.config)
    if args.keyframes:
        config = dataclasses.replace(config, keyframes_path=args.keyframes)
    over = {
        k: v
        for k, v in {"epochs": args.epochs, "batch_size": args.batch_size, "lr": args.lr}.items()
        if v is not None
    }
    if over:
        config = dataclasses.replace(
            config, mapping_train=dataclasses.replace(config.mapping_train, **over)
        )

    model = build_mapping_model(config, args.device)
    store = KeyframeStore(config.keyframes_path)
    store.load(with_embeddings=False)
    log("Keyframes:", len(store))
    images = np.stack([store.read_rgb(i) for i in range(len(store))])
    train_mapping(
        model, config.mapping_train, images,
        log_fn=lambda e, loss: log(f"epoch {e + 1}: loss {loss:.5f}"),
    )
    log("MappingVAE weights ->", save_map(model, config.keyframes_path))
    store.set_embeddings(embed_keyframes(model, store, next(model.parameters()).device))
    store.save()
    log("Embeddings saved:", store.embeddings.shape)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
