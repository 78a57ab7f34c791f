"""Overlay per-frame predictions onto a video.

Equivalent of the reference's prediction_viewer.py. Headless environments get
an annotated export (``--out overlay.mp4``); with a display, an interactive
OpenCV player with trackbar + keyboard transport (space pause, a/d step,
q quit).

    python -m cbas_tpu_torch.tools.prediction_viewer VIDEO CSV [--out overlay.mp4]
"""

from __future__ import annotations

import argparse
import os

import numpy as np
import pandas as pd


def annotate_frame(frame, probs, behaviors, frame_idx, total):
    import cv2

    out = frame.copy()
    top = int(np.argmax(probs))
    h = out.shape[0]
    cv2.putText(out, f"frame {frame_idx}/{total}", (8, 18),
                cv2.FONT_HERSHEY_SIMPLEX, 0.5, (255, 255, 255), 1)
    for i, b in enumerate(behaviors):
        color = (0, 255, 0) if i == top else (200, 200, 200)
        bar_w = int(probs[i] * 120)
        y = 36 + i * 18
        if y > h - 4:
            break
        cv2.putText(out, f"{b[:12]:12s} {probs[i]:.2f}", (8, y),
                    cv2.FONT_HERSHEY_SIMPLEX, 0.45, color, 1)
        cv2.rectangle(out, (150, y - 10), (150 + bar_w, y - 2), color, -1)
    return out


def export_overlay(video_path, df, out_path):
    import cv2

    from cbas_tpu_torch.ingest.decode import open_video

    behaviors = list(df.columns)
    probs = df.to_numpy()
    with open_video(video_path) as reader:
        fps = reader.fps or 10
        writer = cv2.VideoWriter(
            out_path, cv2.VideoWriter_fourcc(*"mp4v"), fps,
            (reader.width, reader.height),
        )
        if not writer.isOpened():
            # A failed VideoWriter swallows every write() silently and the
            # tool would still print "wrote <out>" with exit 0.
            raise IOError(
                f"could not open video writer for '{out_path}' "
                "(bad path or mp4v codec unavailable)"
            )
        n = min(reader.frame_count, len(df))
        for start, batch in reader.iter_chunks(64):
            if start >= n:
                break  # stop decoding once past the last annotated frame
            for j, frame in enumerate(batch):
                idx = start + j
                if idx >= n:
                    break
                annotated = annotate_frame(
                    frame[:, :, ::-1], probs[idx], behaviors, idx, n
                )
                writer.write(annotated)
        writer.release()
    print(f"wrote {out_path}")


def interactive(video_path, df):  # pragma: no cover - needs a display
    import cv2

    behaviors = list(df.columns)
    probs = df.to_numpy()
    cap = cv2.VideoCapture(video_path)
    total = int(cap.get(cv2.CAP_PROP_FRAME_COUNT))
    win = "predictions"
    cv2.namedWindow(win)
    state = {"idx": 0, "playing": True}

    def on_trackbar(v):
        state["idx"] = v

    cv2.createTrackbar("frame", win, 0, max(0, total - 1), on_trackbar)
    next_natural = 0  # frame index the capture will read without a seek
    while True:
        idx = state["idx"]
        # Seek only on jumps: a per-frame CAP_PROP_POS_FRAMES seek forces a
        # keyframe seek + decode-forward for every displayed frame on
        # long-GOP streams (fractional-realtime "playback", possible
        # off-by-keyframe overlay desync). Sequential reads are free.
        if idx != next_natural:
            cap.set(cv2.CAP_PROP_POS_FRAMES, idx)
        ok, frame = cap.read()
        next_natural = idx + 1
        if not ok:
            break
        if idx < len(probs):
            frame = annotate_frame(frame, probs[idx], behaviors, idx, total)
        cv2.imshow(win, frame)
        key = cv2.waitKey(30 if state["playing"] else 0) & 0xFF
        if key == ord("q"):
            break
        if key == ord(" "):
            state["playing"] = not state["playing"]
        elif key == ord("a"):
            state["idx"] = max(0, idx - 1)
        elif key == ord("d"):
            state["idx"] = min(total - 1, idx + 1)
        elif state["playing"]:
            state["idx"] = min(total - 1, idx + 1)
        cv2.setTrackbarPos("frame", win, state["idx"])
    cap.release()
    cv2.destroyAllWindows()


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("video")
    parser.add_argument("csv")
    parser.add_argument("--out", default=None, help="export annotated mp4 instead of playing")
    args = parser.parse_args(argv)

    df = pd.read_csv(args.csv)
    headless = args.out or not os.environ.get("DISPLAY")
    if headless:
        out = args.out or os.path.splitext(args.video)[0] + "_overlay.mp4"
        export_overlay(args.video, df, out)
    else:
        interactive(args.video, df)


if __name__ == "__main__":
    main()
