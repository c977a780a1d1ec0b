"""``scan-tpu-torch`` command-line interface (counterpart of
``scan_tpu/cli.py``; reference ``fcos/bin/fcos:26-58``).

    scan-tpu-torch detect --config-file CFG [--weights W] \\
        [--confidence-threshold T] [--output out.json] \\
        [--set KEY VALUE ...] image.png [...]
    scan-tpu-torch {train,train-da,test} --config-file CFG [KEY VALUE ...]

``detect`` runs ``demo.SCAN`` on each image (on the card unless
``--set MODEL.DEVICE cpu`` asks for the CPU), prints the
detections and writes them as JSON, a list of dicts (``box``, ``score``,
``label``, ``label_name``) under each image's path. ``--set`` is the
port's addition: a config override, which ``detect``'s image list leaves
no room for as trailing options. ``train``, ``train-da`` and ``test`` run
the port's own ``scan_tpu_torch.tools.{train_net,train_net_da,test_net}``.
"""

import argparse
import json
import sys


def main(argv=None):
    parser = argparse.ArgumentParser(prog="scan-tpu-torch")
    sub = parser.add_subparsers(dest="command", required=True)

    d = sub.add_parser("detect", help="run detection on image files")
    d.add_argument("--config-file", required=True)
    d.add_argument("--weights", default=None)
    d.add_argument("--confidence-threshold", type=float, default=0.5)
    d.add_argument("--output", default=None, help="write JSON here")
    d.add_argument("--set", nargs=2, action="append", default=[],
                   metavar=("KEY", "VALUE"), help="a config override")
    d.add_argument("images", nargs="+")

    for name in ("train", "train-da", "test"):
        p = sub.add_parser(name)
        p.add_argument("--config-file", required=True)
        p.add_argument("opts", nargs=argparse.REMAINDER, default=None)

    args = parser.parse_args(argv)

    if args.command == "detect":
        import numpy as np
        from PIL import Image

        from .demo import SCAN

        model = SCAN(args.config_file, args.weights,
                     confidence_threshold=args.confidence_threshold,
                     **dict(args.set))
        results = {}
        for path in args.images:
            with Image.open(path) as im:
                dets = model.detect(np.asarray(im.convert("RGB")))
            results[path] = dets
            print(f"{path}: {len(dets)} detections")
            for det in dets:
                print(f"  {det['label_name']:12s} {det['score']:.3f} "
                      f"{det['box']}")
        if args.output:
            with open(args.output, "w") as f:
                json.dump(results, f, indent=2)
        return 0

    from .tools import test_net, train_net, train_net_da

    tool = {"train": train_net, "train-da": train_net_da,
            "test": test_net}[args.command]
    tool.main(["--config-file", args.config_file] + (args.opts or []))
    return 0


if __name__ == "__main__":
    sys.exit(main())
