"""Segmentation masks and person keypoints (counterpart of
``scan_tpu/structures/masks.py``, the port's own numpy copy).

Parity targets: reference ``fcos_core/structures/segmentation_mask.py``
(BinaryMaskList + PolygonInstance/PolygonList with resize/transpose/crop,
polygon<->bitmask conversion) and ``structures/keypoint.py``
(PersonKeypoints with the flip permutation). The SCAN detection path never
consumes these (masks are commented out of the reference COCODataset,
coco.py:82-84); they complete the structures layer for mask- and
keypoint-capable heads.

Conversion conventions (the reference uses pycocotools + cv2; neither is
assumed here): polygon->mask is an even-odd scanline fill sampled at
integer pixel coordinates with union across an instance's polygons
(pycocotools frPyObjects+merge semantics up to boundary-pixel rounding);
mask->polygon is Moore-neighbour border tracing of each 8-connected
component (the RETR_EXTERNAL contour set). Every rule is ``scan_tpu``'s,
so both packages give the same rasters and contours
(``tests/test_torch_masks.py``).
"""

import dataclasses
from typing import List, Tuple

import numpy as np

FLIP_LEFT_RIGHT = 0
FLIP_TOP_BOTTOM = 1


@dataclasses.dataclass
class PolygonInstance:
    """One instance: list of polygons [x0, y0, x1, y1, ...]."""

    polygons: List[np.ndarray]
    size: Tuple[int, int]  # (w, h)

    def resize(self, new_size):
        w, h = self.size
        nw, nh = new_size
        rw, rh = nw / w, nh / h
        polys = []
        for p in self.polygons:
            q = p.astype(np.float64).copy()
            q[0::2] *= rw
            q[1::2] *= rh
            polys.append(q)
        return PolygonInstance(polys, (nw, nh))

    def transpose(self, method=FLIP_LEFT_RIGHT):
        w, h = self.size
        polys = []
        for p in self.polygons:
            q = p.astype(np.float64).copy()
            if method == FLIP_LEFT_RIGHT:
                q[0::2] = w - q[0::2] - 1
            else:
                q[1::2] = h - q[1::2] - 1
            polys.append(q)
        return PolygonInstance(polys, self.size)

    def crop(self, box):
        """Translate into the (image-clamped) box frame WITHOUT clamping
        the coordinates themselves — reference segmentation_mask.py:238-264
        keeps out-of-box vertices (its clamps are commented out), so a
        later rasterisation clips at the canvas instead of distorting the
        shape along the crop edge."""
        w0, h0 = self.size
        xmin, ymin, xmax, ymax = (float(b) for b in box)
        xmin = min(max(xmin, 0), w0 - 1)
        ymin = min(max(ymin, 0), h0 - 1)
        xmax = min(max(xmax, 0), w0)
        ymax = min(max(ymax, 0), h0)
        xmax = max(xmax, xmin + 1)
        ymax = max(ymax, ymin + 1)
        polys = []
        for p in self.polygons:
            q = p.astype(np.float64).copy()
            q[0::2] -= xmin
            q[1::2] -= ymin
            polys.append(q)
        return PolygonInstance(polys, (int(xmax - xmin), int(ymax - ymin)))

    def rasterize(self) -> np.ndarray:
        """Polygon -> bool bitmask via even-odd scanline fill, union
        across the instance's polygons (pycocotools frPyObjects + merge
        semantics up to boundary-pixel rounding)."""
        w, h = self.size
        mask = np.zeros((h, w), bool)
        for p in self.polygons:
            xs = p[0::2]
            ys = p[1::2]
            n = len(xs)
            if n < 3:
                continue
            yy, xx = np.mgrid[0:h, 0:w]
            inside = np.zeros((h, w), bool)
            j = n - 1
            for i in range(n):
                cond = ((ys[i] > yy) != (ys[j] > yy)) & (
                    xx
                    < (xs[j] - xs[i]) * (yy - ys[i]) / (ys[j] - ys[i] + 1e-12)
                    + xs[i]
                )
                inside ^= cond
                j = i
            mask |= inside
        return mask


# 8-neighbourhood in clockwise order starting from W (dx, dy)
_MOORE = ((-1, 0), (-1, -1), (0, -1), (1, -1),
          (1, 0), (1, 1), (0, 1), (-1, 1))


def _trace_component(comp: np.ndarray, start) -> np.ndarray:
    """Moore-neighbour border tracing of one 8-connected component.

    ``start`` must be the first foreground pixel in scan order (its west
    neighbour is background). Returns the closed outer contour as an
    (M, 2) array of (x, y) pixel coordinates, clockwise, the counterpart
    of one cv2.findContours RETR_EXTERNAL entry
    (reference segmentation_mask.py:137-152)."""
    h, w = comp.shape

    def on(p):
        x, y = p
        return 0 <= x < w and 0 <= y < h and comp[y, x]

    contour = [start]
    # backtrack = the background neighbour we arrived from (west of start)
    prev_dir = 0  # index into _MOORE pointing at the backtrack pixel
    cur = start
    first_move = None
    while True:
        found = False
        # scan clockwise starting just after the backtrack direction
        for k in range(1, 9):
            d = (prev_dir + k) % 8
            nxt = (cur[0] + _MOORE[d][0], cur[1] + _MOORE[d][1])
            if on(nxt):
                # new backtrack: the neighbour just before this hit,
                # re-expressed from the new pixel
                back = (prev_dir + k - 1) % 8
                bpix = (cur[0] + _MOORE[back][0], cur[1] + _MOORE[back][1])
                prev_dir = _MOORE.index(
                    (bpix[0] - nxt[0], bpix[1] - nxt[1])
                )
                cur = nxt
                found = True
                break
        if not found:  # isolated pixel
            break
        if cur == start:
            if first_move is None:
                first_move = contour[-1]
            # Jacob's stopping criterion: stop when re-entering start
            # the same way (one extra lap at most on thin shapes)
            if len(contour) > 1 and contour[-1] == first_move:
                break
            if len(contour) > 4 * h * w:  # safety bound
                break
        contour.append(cur)
        if len(contour) > 4 * h * w:
            break
    # drop the duplicated closing vertex if present
    if len(contour) > 1 and contour[-1] == contour[0]:
        contour.pop()
    return np.asarray(contour, np.float64)


def _find_contours(mask: np.ndarray) -> List[np.ndarray]:
    """External contours of every 8-connected component of a bool mask."""
    m = np.asarray(mask, bool)
    h, w = m.shape
    seen = np.zeros_like(m)
    contours = []
    for y in range(h):
        xs = np.nonzero(m[y] & ~seen[y])[0]
        for x in xs:
            if seen[y, x]:
                continue
            # flood-fill the component (8-connected)
            comp = np.zeros_like(m)
            stack = [(x, y)]
            comp[y, x] = True
            while stack:
                cx, cy = stack.pop()
                for dx, dy in _MOORE:
                    nx, ny = cx + dx, cy + dy
                    if (0 <= nx < w and 0 <= ny < h and m[ny, nx]
                            and not comp[ny, nx]):
                        comp[ny, nx] = True
                        stack.append((nx, ny))
            seen |= comp
            ys2, xs2 = np.nonzero(comp)
            i0 = np.lexsort((xs2, ys2))[0]
            contour = _trace_component(comp, (int(xs2[i0]), int(ys2[i0])))
            contours.append(contour)
    return contours


class BinaryMaskList:
    """Stacked per-instance bitmasks with BoxList-style transforms.

    Parity target: reference ``segmentation_mask.py:33-172``
    (BinaryMaskList): flip via axis reversal, crop with the reference's
    box rounding/clamping, resize via bilinear interpolation with
    align_corners=False followed by truncation toward zero (the
    reference's ``.type_as(uint8)`` cast — a pixel survives only where
    the interpolated value reaches 1.0), and mask->polygon conversion by
    external-contour tracing."""

    def __init__(self, masks, size: Tuple[int, int]):
        masks = np.asarray(masks)
        if masks.ndim == 2:
            masks = masks[None]
        assert masks.ndim == 3
        assert masks.shape[1] == size[1] and masks.shape[2] == size[0], (
            f"{masks.shape} vs size {size}"
        )
        self.masks = masks.astype(bool).copy()
        self.size = tuple(size)

    def __len__(self):
        return len(self.masks)

    def __getitem__(self, idx):
        return BinaryMaskList(self.masks[idx], self.size)

    def transpose(self, method=FLIP_LEFT_RIGHT):
        axis = 1 if method == FLIP_TOP_BOTTOM else 2
        return BinaryMaskList(np.flip(self.masks, axis), self.size)

    def crop(self, box):
        w0, h0 = self.size
        xmin, ymin, xmax, ymax = (int(round(float(b))) for b in box)
        xmin = min(max(xmin, 0), w0 - 1)
        ymin = min(max(ymin, 0), h0 - 1)
        xmax = min(max(xmax, 0), w0)
        ymax = min(max(ymax, 0), h0)
        xmax = max(xmax, xmin + 1)
        ymax = max(ymax, ymin + 1)
        return BinaryMaskList(
            self.masks[:, ymin:ymax, xmin:xmax],
            (xmax - xmin, ymax - ymin),
        )

    def resize(self, new_size):
        nw, nh = (int(s) for s in new_size)
        w0, h0 = self.size
        # bilinear sample positions, align_corners=False (reference
        # segmentation_mask.py:120-128 via F.interpolate)
        sy = (np.arange(nh) + 0.5) * h0 / nh - 0.5
        sx = (np.arange(nw) + 0.5) * w0 / nw - 0.5
        y0 = np.clip(np.floor(sy), 0, h0 - 1).astype(int)
        x0 = np.clip(np.floor(sx), 0, w0 - 1).astype(int)
        y1 = np.clip(y0 + 1, 0, h0 - 1)
        x1 = np.clip(x0 + 1, 0, w0 - 1)
        fy = np.clip(sy - y0, 0.0, 1.0)[None, :, None]
        fx = np.clip(sx - x0, 0.0, 1.0)[None, None, :]
        m = self.masks.astype(np.float64)
        top = m[:, y0][:, :, x0] * (1 - fx) + m[:, y0][:, :, x1] * fx
        bot = m[:, y1][:, :, x0] * (1 - fx) + m[:, y1][:, :, x1] * fx
        val = top * (1 - fy) + bot * fy
        # .type_as(uint8 masks) truncates: only exactly-1.0 survives
        return BinaryMaskList(val >= 1.0 - 1e-9, (nw, nh))

    def convert_to_polygon(self) -> "SegmentationMask":
        instances = []
        for m in self.masks:
            polys = [c.reshape(-1) for c in _find_contours(m) if len(c) >= 3]
            instances.append(PolygonInstance(polys, self.size))
        return SegmentationMask(instances, self.size, mode="poly")

    def get_mask_tensor(self) -> np.ndarray:
        return self.masks.squeeze()


class SegmentationMask:
    """Polygon- or mask-mode segmentation container with BoxList-style
    transforms and mode conversion (reference segmentation_mask.py:332-533
    SegmentationMask wrapping PolygonList/BinaryMaskList)."""

    def __init__(self, instances, size: Tuple[int, int], mode="poly"):
        self.size = tuple(size)
        self.mode = mode
        if mode == "mask":
            self.instances = (
                instances
                if isinstance(instances, BinaryMaskList)
                else BinaryMaskList(instances, self.size)
            )
        else:
            self.instances = [
                inst
                if isinstance(inst, PolygonInstance)
                else PolygonInstance(
                    [np.asarray(p, np.float64) for p in inst], self.size
                )
                for inst in instances
            ]

    def __len__(self):
        return len(self.instances)

    def __getitem__(self, idx):
        return self.instances[idx]

    def resize(self, new_size):
        if self.mode == "mask":
            return SegmentationMask(
                self.instances.resize(new_size), new_size, "mask"
            )
        return SegmentationMask(
            [i.resize(new_size) for i in self.instances], new_size, self.mode
        )

    def transpose(self, method=FLIP_LEFT_RIGHT):
        if self.mode == "mask":
            return SegmentationMask(
                self.instances.transpose(method), self.size, "mask"
            )
        return SegmentationMask(
            [i.transpose(method) for i in self.instances], self.size, self.mode
        )

    def crop(self, box):
        if self.mode == "mask":
            cropped = self.instances.crop(box)
            return SegmentationMask(cropped, cropped.size, "mask")
        new = [i.crop(box) for i in self.instances]
        new_size = new[0].size if new else (
            int(box[2] - box[0]), int(box[3] - box[1])
        )
        return SegmentationMask(new, new_size, self.mode)

    def convert(self, mode: str) -> "SegmentationMask":
        if mode == self.mode:
            return self
        if mode == "mask":
            return SegmentationMask(
                BinaryMaskList(self.to_bitmask_array(), self.size),
                self.size, "mask",
            )
        assert mode == "poly", mode
        converted = self.instances.convert_to_polygon()
        return converted

    def get_mask_tensor(self) -> np.ndarray:
        return self.to_bitmask_array().squeeze()

    def to_bitmask_array(self) -> np.ndarray:
        if self.mode == "mask":
            return self.instances.masks
        return (
            np.stack([i.rasterize() for i in self.instances])
            if self.instances
            else np.zeros((0,) + self.size[::-1], bool)
        )


PERSON_KEYPOINT_NAMES = (
    "nose", "left_eye", "right_eye", "left_ear", "right_ear",
    "left_shoulder", "right_shoulder", "left_elbow", "right_elbow",
    "left_wrist", "right_wrist", "left_hip", "right_hip", "left_knee",
    "right_knee", "left_ankle", "right_ankle",
)
_FLIP_MAP = {
    "left_eye": "right_eye", "left_ear": "right_ear",
    "left_shoulder": "right_shoulder", "left_elbow": "right_elbow",
    "left_wrist": "right_wrist", "left_hip": "right_hip",
    "left_knee": "right_knee", "left_ankle": "right_ankle",
}


def _flip_inds():
    full = dict(_FLIP_MAP, **{v: k for k, v in _FLIP_MAP.items()})
    return [
        PERSON_KEYPOINT_NAMES.index(full.get(n, n))
        for n in PERSON_KEYPOINT_NAMES
    ]


class PersonKeypoints:
    """(N, 17, 3) keypoints [x, y, visibility] with resize/flip."""

    NAMES = PERSON_KEYPOINT_NAMES

    def __init__(self, keypoints, size):
        kp = np.asarray(keypoints, np.float64).reshape(-1, 17, 3)
        self.keypoints = kp
        self.size = tuple(size)

    def __len__(self):
        return len(self.keypoints)

    def resize(self, new_size):
        w, h = self.size
        nw, nh = new_size
        kp = self.keypoints.copy()
        kp[..., 0] *= nw / w
        kp[..., 1] *= nh / h
        return PersonKeypoints(kp, new_size)

    def transpose(self, method=FLIP_LEFT_RIGHT):
        """Horizontal flip swaps left/right keypoints and mirrors x
        (reference keypoint.py:40-58). Vertical flip mirrors y without a
        name swap — the reference raises NotImplementedError there
        (keypoint.py:42); supported here for transform completeness."""
        if method == FLIP_LEFT_RIGHT:
            w = self.size[0]
            kp = self.keypoints[:, _flip_inds()].copy()
            kp[..., 0] = w - kp[..., 0] - 1
        elif method == FLIP_TOP_BOTTOM:
            h = self.size[1]
            kp = self.keypoints.copy()
            kp[..., 1] = h - kp[..., 1] - 1
        else:
            raise NotImplementedError(f"unknown transpose method {method}")
        # COCO convention: visibility == 0 -> the whole keypoint is 0
        # (reference keypoint.py:52-54 zeroes x, y AND visibility)
        kp *= (kp[..., 2:3] > 0)
        return PersonKeypoints(kp, self.size)
