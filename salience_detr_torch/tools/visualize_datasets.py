"""Draw the ground-truth boxes of a COCO-format dataset to disk (the twin of
the JAX tool ``tools/visualize_datasets.py``), through the port's
``CocoDetection`` and, with ``--transform``, one of its train presets
(``data.transforms.PRESETS``).

    python -m salience_detr_torch.tools.visualize_datasets --img-folder DIR --ann-file F
        [--show-dir dataset_visualization] [--limit 100] [--transform PRESET]

Each sample's image is written as ``<image_id>.jpg`` with its boxes and
class names (``utils.visualize.save_visualization``; drawing needs cv2).
Images are read as ``CocoDetection`` reads them (cv2, or numpy for
``.npy`` files)."""

from __future__ import annotations

import argparse
import os


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--img-folder", required=True)
    p.add_argument("--ann-file", required=True)
    p.add_argument("--show-dir", default="dataset_visualization")
    p.add_argument("--limit", type=int, default=100)
    p.add_argument("--transform", default=None, help="optional preset to preview")
    args = p.parse_args(argv)

    from salience_detr_torch.data.coco import CocoDetection
    from salience_detr_torch.data.transforms import build_preset
    from salience_detr_torch.utils.visualize import require_cv2, save_visualization

    require_cv2()
    transforms = build_preset(args.transform) if args.transform else None
    ds = CocoDetection(args.img_folder, args.ann_file, transforms=transforms)
    names = {c["id"]: c["name"] for c in ds.coco.cats.values()}
    max_id = max(names) if names else 0
    class_names = [names.get(i, str(i)) for i in range(max_id + 1)]

    os.makedirs(args.show_dir, exist_ok=True)
    for i in range(min(len(ds), args.limit)):
        s = ds[i]
        out = os.path.join(args.show_dir, f"{s['image_id']}.jpg")
        save_visualization(s["image"], {"boxes": s["boxes"], "labels": s["labels"]}, out, class_names=class_names)
    print(f"wrote {min(len(ds), args.limit)} visualizations to {args.show_dir}")


if __name__ == "__main__":
    main()
