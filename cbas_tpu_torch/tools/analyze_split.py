"""Split composition report: what a seeded split would look like.

Working replacement for the reference's stale analyze_split.py (it calls an
API that no longer exists; see SURVEY.md §2.5). Prints per-split subject lists
and per-behavior instance/frame counts.

    python -m cbas_tpu_torch.tools.analyze_split --project P --dataset D \
        [--seed 42] [--ratios 0.7 0.15 0.15] [--runs 1]
"""

from __future__ import annotations

import argparse
from collections import Counter

from cbas_tpu_torch.core.project import Project
from cbas_tpu_torch.core.splits import RandomSplitProvider, subject_of


def composition(instances, subjects) -> dict:
    chosen_set = set(subjects)
    chosen = [i for i in instances if subject_of(i) in chosen_set]
    n = Counter(i["label"] for i in chosen)
    frames: Counter = Counter()
    for i in chosen:
        frames[i["label"]] += int(i["end"]) - int(i["start"]) + 1
    return {"instances": dict(n), "frames": dict(frames), "n_subjects": len(subjects)}


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--project", required=True)
    parser.add_argument("--dataset", required=True)
    parser.add_argument("--seed", type=int, default=42)
    parser.add_argument("--ratios", type=float, nargs=3, default=(0.7, 0.15, 0.15))
    parser.add_argument("--runs", type=int, default=1)
    args = parser.parse_args(argv)

    proj = Project(args.project)
    ds = proj.datasets[args.dataset]
    instances = ds.all_instances()
    subjects = sorted({subject_of(i) for i in instances})
    behaviors = ds.behaviors
    print(f"Dataset '{args.dataset}': {len(instances)} instances, "
          f"{len(subjects)} subjects, behaviors={behaviors}")

    provider = RandomSplitProvider(seed=args.seed, split_ratios=tuple(args.ratios))
    for run in range(args.runs):
        train, val, test = provider.get_split(
            run, subjects, instances, behaviors, allow_relaxed_fallback=True
        )
        print(f"\n=== Run {run} (seed {args.seed + run}) ===")
        for name, subj in (("train", train), ("val", val), ("test", test)):
            comp = composition(instances, subj)
            print(f"  {name}: {comp['n_subjects']} subjects {sorted(subj)}")
            for b in behaviors:
                print(
                    f"    {b}: {comp['instances'].get(b, 0)} instances "
                    f"({comp['frames'].get(b, 0)} frames)"
                )


if __name__ == "__main__":
    main()
