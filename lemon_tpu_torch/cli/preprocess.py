"""Offline preprocessing CLI (port of lemon_tpu/cli/preprocess.py, host
only): regenerate multimodal_mislabel_split files from raw dataset sources
(the reference does this in notebooks/preprocess_*.ipynb; builders live in
lemon_tpu_torch.data.preprocess).

    python -m lemon_tpu_torch.cli.preprocess mscoco --karpathy dataset_coco.json \
        --instances instances_train2014.json instances_val2014.json --out <root>
    python -m lemon_tpu_torch.cli.preprocess flickr30 --karpathy dataset_flickr30k.json --out <root>
    python -m lemon_tpu_torch.cli.preprocess imagenet_red --annotations a.json --img_dir <dir>
    python -m lemon_tpu_torch.cli.preprocess cc3m --img_dir <wds-extract> --out <root>
    python -m lemon_tpu_torch.cli.preprocess mmimdb --root <mmimdb> --out <root>
"""

from __future__ import annotations

import argparse
from pathlib import Path


def main(argv=None):
    p = argparse.ArgumentParser(description="lemon_tpu_torch offline preprocessing")
    sub = p.add_subparsers(dest="dataset", required=True)

    s = sub.add_parser("mscoco")
    s.add_argument("--karpathy", required=True)
    s.add_argument("--instances", nargs="+", required=True)
    s.add_argument("--out", required=True)

    s = sub.add_parser("flickr30")
    s.add_argument("--karpathy", required=True)
    s.add_argument("--out", required=True)

    s = sub.add_parser("imagenet_red")
    s.add_argument("--annotations", required=True)
    s.add_argument("--img_dir", required=True)

    s = sub.add_parser("cc3m")
    s.add_argument("--img_dir", required=True)
    s.add_argument("--out", required=True)

    s = sub.add_parser("mmimdb")
    s.add_argument("--root", required=True)
    s.add_argument("--out", required=True)

    s = sub.add_parser("mimiccxr")
    s.add_argument("--jpg_root", required=True,
                   help="MIMIC-CXR-JPG root (contains mimic-cxr-2.0.0-{chexpert,split}.csv.gz)")
    s.add_argument("--reports", required=True, help="mimic-cxr-reports files/ root")
    s.add_argument("--out", required=True)

    args = p.parse_args(argv)
    from lemon_tpu_torch.data import preprocess as pp

    if args.dataset == "mscoco":
        out = pp.build_mscoco(Path(args.karpathy), [Path(i) for i in args.instances], Path(args.out))
    elif args.dataset == "flickr30":
        out = pp.build_flickr30(Path(args.karpathy), Path(args.out))
    elif args.dataset == "imagenet_red":
        df = pp.build_imagenet_red(Path(args.annotations), Path(args.img_dir))
        out = Path(args.img_dir) / "multimodal_mislabel_split.csv"
        print(f"{len(df)} rows")
    elif args.dataset == "cc3m":
        out = pp.build_cc3m(Path(args.img_dir), Path(args.out))
    elif args.dataset == "mimiccxr":
        df = pp.build_mimiccxr(Path(args.jpg_root), Path(args.reports), Path(args.out))
        out = Path(args.out) / "multimodal_mislabel_split.pkl"
        print(f"{len(df)} rows")
    else:
        out = pp.build_mmimdb(Path(args.root), Path(args.out))
    print(f"wrote {out}")


if __name__ == "__main__":
    main()
