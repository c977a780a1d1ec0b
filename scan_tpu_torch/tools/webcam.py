"""Webcam demo (counterpart of ``tools/webcam.py``; reference
``demo/webcam.py``): live detection overlay.

    python -m scan_tpu_torch.tools.webcam --config-file CFG [--weights W]

Runs ``demo.Predictor`` on ``MODEL.DEVICE`` (the card unless ``cpu`` is
given) on each camera frame. Needs OpenCV (``cv2``), imported only here;
ESC ends it.
"""

import argparse


def main(argv=None):
    parser = argparse.ArgumentParser(description="SCAN webcam demo (PyTorch)")
    parser.add_argument("--config-file", required=True)
    parser.add_argument("--weights", default=None)
    parser.add_argument("--confidence-threshold", type=float, default=0.5)
    parser.add_argument("--camera", type=int, default=0)
    args = parser.parse_args(argv)

    import cv2

    from ..config import get_default_cfg
    from ..demo import Predictor

    cfg = get_default_cfg()
    cfg.merge_from_file(args.config_file)
    predictor = Predictor(
        cfg, args.weights, confidence_threshold=args.confidence_threshold)
    cam = cv2.VideoCapture(args.camera)
    if not cam.isOpened():
        raise SystemExit(f"cannot open camera {args.camera}")
    try:
        while True:
            ok, frame_bgr = cam.read()
            if not ok:
                break
            rgb = cv2.cvtColor(frame_bgr, cv2.COLOR_BGR2RGB)
            overlay = predictor.run_on_image(rgb)
            cv2.imshow("scan-tpu-torch",
                       cv2.cvtColor(overlay, cv2.COLOR_RGB2BGR))
            if cv2.waitKey(1) == 27:  # ESC
                break
    finally:
        cam.release()
        cv2.destroyAllWindows()


if __name__ == "__main__":
    main()
