"""Single-image / folder demo (counterpart of ``tools/demo.py``; reference
``demo/fcos_demo.py``): each image in, its detections printed and the image
with them drawn saved as a PNG of the same name in ``--out-dir``.

    python -m scan_tpu_torch.tools.demo --config-file configs/scan/....yaml \\
        [--weights ckpt.pth] --images img1.png img2.png [--out-dir demo_out] \\
        [KEY VALUE ...]

Runs on the card unless ``MODEL.DEVICE cpu`` asks for the CPU.
"""

import argparse
import os


def main(argv=None):
    parser = argparse.ArgumentParser(description="SCAN demo (PyTorch)")
    parser.add_argument("--config-file", required=True)
    parser.add_argument("--weights", default=None)
    parser.add_argument("--images", nargs="+", required=True)
    parser.add_argument("--out-dir", default="demo_out")
    parser.add_argument("--confidence-threshold", type=float, default=0.5)
    parser.add_argument("opts", nargs=argparse.REMAINDER, default=None)
    args = parser.parse_args(argv)

    import numpy as np
    from PIL import Image

    from ..config import get_default_cfg
    from ..demo import Predictor, draw_detections

    cfg = get_default_cfg()
    cfg.merge_from_file(args.config_file)
    if args.opts:
        cfg.merge_from_list(args.opts)
    predictor = Predictor(cfg, args.weights,
                          confidence_threshold=args.confidence_threshold)
    os.makedirs(args.out_dir, exist_ok=True)
    written = []
    for path in args.images:
        with Image.open(path) as im:
            img = np.asarray(im.convert("RGB"))
        dets = predictor.detect(img)
        print(f"{path}: {len(dets)} detections")
        for d in dets:
            print(f"  {d['label_name']:12s} {d['score']:.3f} {d['box']}")
        out_path = os.path.join(args.out_dir, os.path.basename(path))
        Image.fromarray(draw_detections(img, dets)).save(out_path)
        print(f"  saved {out_path}")
        written.append(out_path)
    return written


if __name__ == "__main__":
    main()
