"""End-to-end demo of the port on a synthetic project.

Builds a project with generated videos, encodes them with a small
randomly-initialized ViT, labels two behaviors programmatically, trains a
classifier head, runs inference, and renders an actogram: the full pipeline
without pretrained checkpoints, in the same six steps and at the same sizes
as ``examples/end_to_end_demo.py``.

    python -m cbas_tpu_torch.examples.end_to_end_demo /tmp/demo [--device cpu]

It runs on the CUDA device unless ``--device cpu`` asks for the CPU, and
never falls back to the CPU: without a card it stops, naming CUDA, before
it writes anything. On the card the encoder (2 heads of 64, fp32) runs the
flat attention kernel on its fp32 body, with its prologue, and every
LayerNorm through the LayerNorm kernel.

The encoder's weights come from the port's numpy init
(``init_vit_params(0, cfg)``), not from the JAX demo's ``jax.random.key(0)``,
so its embeddings and probabilities are not the JAX demo's numbers.

It needs h5py, pandas, OpenCV, matplotlib and scikit-learn (the training
job draws its confusion matrices with it) and names any that are missing
before it starts.
"""

from __future__ import annotations

import argparse
import base64
import json
import os
import sys

import numpy as np

# The synthetic project: CLIPS videos of FRAMES frames at RES x RES.
CLIPS, FRAMES, RES = 8, 300, 64
REQUIRED = ("h5py", "pandas", "cv2", "matplotlib", "sklearn")


def check_host(device: str) -> None:
    """Raises ``RuntimeError`` naming CUDA where ``device`` is a CUDA device
    and none is visible, or naming the packages of ``REQUIRED`` this host
    lacks."""
    from cbas_tpu_torch.tools._device import require_device

    require_device(device)
    missing = []
    for mod in REQUIRED:
        try:
            __import__(mod)
        except ImportError:
            missing.append(mod)
    if missing:
        raise RuntimeError(f"the demo needs {', '.join(missing)}, which is not installed")


def main(root: str, device: str = "cuda") -> dict:
    """Run the six steps under ``root`` on ``device``; returns the model
    directory, the CSV and PNG written and the two mean probabilities."""
    check_host(device)

    import cv2
    import pandas as pd
    import torch
    from safetensors.numpy import save_file

    from cbas_tpu_torch.app.visualize import Actogram, stitch_outputs
    from cbas_tpu_torch.core.config import EncodeConfig, TrainingConfig, dump_yaml
    from cbas_tpu_torch.core.project import Project
    from cbas_tpu_torch.engine.classifier import ClassifierBundle
    from cbas_tpu_torch.engine.encode import encode_file
    from cbas_tpu_torch.engine.infer import infer_file
    from cbas_tpu_torch.engine.orchestrator import run_training_job
    from cbas_tpu_torch.models.encoder import FrameEncoder
    from cbas_tpu_torch.models.vit import ViTConfig, init_vit_params

    print("== 1. Create project with synthetic recordings ==")
    proj = Project.create_project(root, "demo")
    rng = np.random.default_rng(0)
    res, frames = RES, FRAMES
    videos = []
    for s in range(CLIPS):
        rec = os.path.join(proj.recordings_dir, "sess1", f"mouse{s}")
        os.makedirs(rec)
        path = os.path.join(rec, f"mouse{s}_00001.mp4")
        w = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*"mp4v"), 10, (res, res))
        for i in range(frames):
            frame = rng.integers(0, 60, (res, res, 3), np.uint8)
            # First half: bright moving blob ("active"); second half: dark ("rest").
            if i < frames // 2:
                x = (i * 3) % (res - 16)
                frame[:, :, 1] = frame[:, :, 1] // 2 + 120  # bright scene
                frame[20:36, x : x + 16, 1] = 255
            w.write(frame)
        w.release()
        videos.append(path)
    proj.reload()

    print(f"== 2. Encode with a small random ViT (stands in for DINOv3) on {device} ==")
    # The encoder ships INSIDE the project (safetensors + HF-style
    # config.json) and cbas_config.yaml points at it by relative path, so the
    # project is fully portable.
    cfg = ViTConfig(
        variant="dinov3", hidden_size=128, num_layers=2, num_heads=2, patch_size=16,
        num_register_tokens=4, intermediate_size=256, layer_norm_eps=1e-5,
    )
    enc_dir = os.path.join(proj.path, "demo_encoder")
    os.makedirs(enc_dir, exist_ok=True)
    save_file(init_vit_params(0, cfg), os.path.join(enc_dir, "model.safetensors"))
    with open(os.path.join(enc_dir, "config.json"), "w") as f:
        json.dump(
            {
                "model_type": "dinov3_vit",
                "hidden_size": cfg.hidden_size,
                "num_hidden_layers": cfg.num_layers,
                "num_attention_heads": cfg.num_heads,
                "patch_size": cfg.patch_size,
                "num_register_tokens": cfg.num_register_tokens,
                "intermediate_size": cfg.intermediate_size,
                "layer_norm_eps": cfg.layer_norm_eps,
            },
            f,
            indent=2,
        )
    dump_yaml({"encoder_model_identifier": "demo_encoder"},
              os.path.join(proj.path, "cbas_config.yaml"))
    proj.reload_settings()
    encoder = FrameEncoder(proj.encoder_model_identifier, compute_dtype=torch.float32,
                           device=device)
    for v in videos:
        out = encode_file(encoder, v, config=EncodeConfig(chunk_frames=64))
        print("   encoded:", os.path.basename(out))

    print("== 3. Label the two behaviors programmatically ==")
    ds = proj.create_dataset("demo_behaviors", ["active", "rest"], [])
    labels = {"active": [], "rest": []}
    half = frames // 2
    for v in videos:
        rel = os.path.relpath(v, proj.path)
        labels["active"].append({"video": rel, "start": 20, "end": half - 20, "label": "active"})
        labels["rest"].append({"video": rel, "start": half + 20, "end": frames - 20, "label": "rest"})
    ds.labels["labels"] = labels
    ds.save_labels()
    proj.reload()

    print("== 4. Train the classifier head ==")
    task = TrainingConfig(
        name="demo_behaviors", behaviors=["active", "rest"], batch_size=128,
        learning_rate=3e-3, epochs=4, sequence_length=15, patience=3,
        num_runs=1, num_trials=1, use_test=True, test_split=0.2,
        lstm_hidden_size=32,
    )
    model_dir = run_training_job(proj, task, seed=7, device=device)
    print("   model saved to:", model_dir)

    print("== 5. Inference ==")
    bundle = ClassifierBundle.load(model_dir, expected_encoder=proj.encoder_model_identifier)
    h5 = videos[0].replace(".mp4", "_cls.h5")
    csv = infer_file(h5, bundle, device=device)
    print("   predictions:", os.path.basename(csv))

    print("== 6. Actogram ==")
    df = stitch_outputs(os.path.dirname(videos[0]), bundle.name)
    acto = Actogram(
        behavior="active", framerate=300 / 3600, start=0, binsize_minutes=30,
        threshold=0.5, preloaded_df=df, model=bundle.name,
    )
    out_png = None
    if acto.blob:
        out_png = os.path.join(root, "actogram_active.png")
        with open(out_png, "wb") as f:
            f.write(base64.b64decode(acto.blob))
        print("   wrote:", out_png)

    probs = pd.read_csv(csv)
    acc_active = float(probs.iloc[30 : half - 30]["active"].mean())
    acc_rest = float(probs.iloc[half + 30 : -30]["rest"].mean())
    print(f"== done: mean P(active|first half)={acc_active:.2f}, "
          f"P(rest|second half)={acc_rest:.2f} ==")
    return {"project": proj.path, "model_dir": model_dir, "csv": csv, "png": out_png,
            "p_active": acc_active, "p_rest": acc_rest}


def cli(argv=None) -> None:
    parser = argparse.ArgumentParser(description=__doc__,
                                     formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("root", help="directory the demo project is created in")
    parser.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                        help="where the encoder, training and inference run (default: cuda)")
    args = parser.parse_args(argv)
    try:
        check_host(args.device)
    except RuntimeError as e:
        sys.exit(f"end_to_end_demo: {e}")
    main(args.root, args.device)


if __name__ == "__main__":
    cli()
