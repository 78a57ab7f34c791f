"""Inspect embedding files: encoder stamp, schema, frame count.

Merges the reference's check_h5_encoder.py and check_h5_length.py into one
tool:

    python -m cbas_tpu_torch.tools.check_h5 file1_cls.h5 [file2_cls.h5 ...]
    python -m cbas_tpu_torch.tools.check_h5 --expect facebook/dinov3-vitb16 *.h5
"""

from __future__ import annotations

import argparse
import sys


def inspect(path: str, expect: str | None) -> dict:
    info = {"path": path, "ok": False}
    try:
        import h5py  # here, not at the top: the package imports without h5py

        with h5py.File(path, "r") as f:
            info["encoder"] = f.attrs.get("encoder_model_identifier")
            info["schema"] = f.attrs.get("schema_version")
            if "cls" in f:
                info["frames"] = int(f["cls"].shape[0])
                info["dim"] = int(f["cls"].shape[1])
                info["dtype"] = str(f["cls"].dtype)
            if expect is None:
                matches = True
            else:
                # Same acceptance rule as the pipeline (hdf5_store
                # .is_stamp_valid): raw string equality would report BAD for
                # stamps the app itself treats as valid (project-local
                # encoder paths after a host move, legacy fingerprint forms).
                from cbas_tpu_torch.utils.naming import identities_equivalent

                matches = identities_equivalent(str(info["encoder"]), expect)
            info["ok"] = "cls" in f and info["encoder"] is not None and matches
    except Exception as e:
        info["error"] = str(e)
    return info


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("files", nargs="+")
    parser.add_argument("--expect", default=None, help="required encoder identifier")
    args = parser.parse_args(argv)

    bad = 0
    for path in args.files:
        info = inspect(path, args.expect)
        status = "OK " if info["ok"] else "BAD"
        detail = (
            f"frames={info.get('frames', '?')} dim={info.get('dim', '?')} "
            f"dtype={info.get('dtype', '?')} encoder={info.get('encoder')} "
            f"schema={info.get('schema')}"
        )
        if "error" in info:
            detail = f"error={info['error']}"
        print(f"[{status}] {path}: {detail}")
        bad += not info["ok"]
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
