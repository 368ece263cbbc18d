"""Host-side augmentation pipelines (PIL/cv2/numpy), NHWC — a copy of
``arseg_tpu/data/transform.py`` (the port imports nothing of the JAX
package). PIL and cv2 are imported where an op runs, never when the module
is imported.

The reference transform families (``dataset/transform.py``): single
(im+label), pair (im+ref share every RNG draw), and pairOF (the ref's "label" slot carries the motion-vector map; flip
negates the x component, scale resamples with cv2 INTER_NEAREST and — in the
V2 variant actually used — multiplies MV magnitude by the scale,
`dataset/transform.py:292-320`; crop slices the array).

RNG: a shared python `random.Random` instance passed at construction keeps
draw order identical to the reference (which uses the global `random`).
A ``SampleRng`` in its place gives each sample draws of its own, which the
``Loader`` seeds from the sample's place in the epoch: the trainers use it,
so that a sample's augmentation is the same whichever thread or rank reads
it.
"""

import random as _random
import threading

import numpy as np


class SampleRng:
    """A drop-in for the shared ``random.Random``: every draw comes from a
    generator of the calling thread, which ``seed(s)`` starts anew. The
    ``Loader`` seeds it before each sample it reads."""

    def __init__(self):
        self._local = threading.local()

    def seed(self, s):
        self._local.rng = _random.Random(s)

    def __getattr__(self, name):  # random(), uniform(), choice(), ...
        local = self.__dict__["_local"]
        rng = getattr(local, "rng", None)
        if rng is None:
            rng = local.rng = _random.Random()
        return getattr(rng, name)


def _image():
    from PIL import Image

    return Image


class Pipeline:
    """Compose for single-sample dict {'im': PIL, 'lb': PIL} transforms."""

    def __init__(self, ops):
        self.ops = ops

    def __call__(self, im_lb):
        for op in self.ops:
            im_lb = op(im_lb)
        return im_lb


class PairPipeline:
    """Compose for multi-party transforms: every op receives all parties and
    shares one RNG draw across them. Works for the reference's pair, pairOF,
    triple and tripleOF families alike (`dataset/transform.py:115-658`) — the
    party count is just the number of dicts passed."""

    def __init__(self, ops):
        self.ops = ops

    def __call__(self, *parties):
        for op in self.ops:
            parties = op(*parties)
        return parties


TriplePipeline = PairPipeline


class RandomCrop:
    def __init__(self, size, rng=None):
        self.size = size
        self.rng = rng or _random

    def _params(self, w, h):
        W, H = self.size
        resize = None
        if w < W or h < H:
            scale = float(W) / w if w < h else float(H) / h
            w, h = int(scale * w + 1), int(scale * h + 1)
            resize = (w, h)
        sw = self.rng.random() * (w - W)
        sh = self.rng.random() * (h - H)
        crop = (int(sw), int(sh), int(sw) + W, int(sh) + H)
        return resize, crop

    def __call__(self, im_lb):
        im, lb = im_lb["im"], im_lb["lb"]
        if (tuple(self.size)) == im.size:
            return im_lb
        resize, crop = self._params(*im.size)
        if resize:
            im = im.resize(resize, _image().BILINEAR)
            lb = lb.resize(resize, _image().NEAREST)
        return dict(im=im.crop(crop), lb=lb.crop(crop))


class HorizontalFlip:
    def __init__(self, p=0.5, rng=None):
        self.p = p
        self.rng = rng or _random

    def __call__(self, im_lb):
        if self.rng.random() > self.p:
            return im_lb
        return dict(
            im=im_lb["im"].transpose(_image().FLIP_LEFT_RIGHT),
            lb=im_lb["lb"].transpose(_image().FLIP_LEFT_RIGHT),
        )


class RandomScale:
    def __init__(self, scales=(1,), rng=None):
        self.scales = scales
        self.rng = rng or _random

    def __call__(self, im_lb):
        im, lb = im_lb["im"], im_lb["lb"]
        scale = self.rng.choice(self.scales)
        w, h = int(im.size[0] * scale), int(im.size[1] * scale)
        return dict(
            im=im.resize((w, h), _image().BILINEAR), lb=lb.resize((w, h), _image().NEAREST)
        )


class ColorJitter:
    def __init__(self, brightness=None, contrast=None, saturation=None, rng=None):
        self.rng = rng or _random
        self.brightness = [max(1 - brightness, 0), 1 + brightness] if brightness else None
        self.contrast = [max(1 - contrast, 0), 1 + contrast] if contrast else None
        self.saturation = [max(1 - saturation, 0), 1 + saturation] if saturation else None

    def _draw(self):
        return (
            self.rng.uniform(*self.brightness),
            self.rng.uniform(*self.contrast),
            self.rng.uniform(*self.saturation),
        )

    @staticmethod
    def _enhance(im, rb, rc, rs):
        from PIL import ImageEnhance

        im = ImageEnhance.Brightness(im).enhance(rb)
        im = ImageEnhance.Contrast(im).enhance(rc)
        return ImageEnhance.Color(im).enhance(rs)

    def __call__(self, im_lb):
        rb, rc, rs = self._draw()
        return dict(im=self._enhance(im_lb["im"], rb, rc, rs), lb=im_lb["lb"])


class MultiScale:
    def __init__(self, scales):
        self.scales = scales

    def __call__(self, img):
        W, H = img.size
        return [
            img.resize((int(W * r), int(H * r)), _image().BILINEAR) for r in self.scales
        ]


# ------------------------------------------- pair / triple (+OF) variants
#
# N-ary transforms: each __call__ takes any number of {'im','lb'} dicts,
# draws its random parameters ONCE, and applies them to every party. A
# party's 'lb' slot is either a PIL label map or an [H, W, 2] numpy MV
# array (the reference's *OF* families, `dataset/transform.py:198-320`);
# geometry is dispatched on that type, so pair/pairOF/triple/tripleOF all
# collapse into one implementation.


def _resize_flow_nearest(flow, w, h):
    import cv2

    # the reference pads to 3 channels before cv2.resize; behaviour-identical
    flow3 = np.concatenate([flow, flow[..., 0:1]], axis=-1)
    flow3 = cv2.resize(flow3, dsize=(w, h), interpolation=cv2.INTER_NEAREST)
    return flow3[..., :2]


def _is_flow(lb):
    return isinstance(lb, np.ndarray)


class PairColorJitter(ColorJitter):
    def __call__(self, *parties):
        rb, rc, rs = self._draw()
        return tuple(
            dict(im=self._enhance(d["im"], rb, rc, rs), lb=d["lb"]) for d in parties
        )


class PairHorizontalFlip(HorizontalFlip):
    def __call__(self, *parties):
        if self.rng.random() > self.p:
            return parties

        def f(d):
            lb = d["lb"]
            if _is_flow(lb):
                # flip negates the x motion component (transform.py:252-253)
                lb = np.array(lb)
                lb[..., 0] = -lb[..., 0]
                lb = np.fliplr(lb)
            else:
                lb = lb.transpose(_image().FLIP_LEFT_RIGHT)
            return dict(im=d["im"].transpose(_image().FLIP_LEFT_RIGHT), lb=lb)

        return tuple(f(d) for d in parties)


class PairRandomScale(RandomScale):
    """scale_mv=True additionally multiplies MV magnitude by the drawn scale
    — the V2 behaviour the reference trains with (transform.py:292-320)."""

    def __init__(self, scales=(1,), rng=None, scale_mv=True):
        super().__init__(scales, rng=rng)
        self.scale_mv = scale_mv

    def __call__(self, *parties):
        scale = self.rng.choice(self.scales)
        w = int(parties[0]["im"].size[0] * scale)
        h = int(parties[0]["im"].size[1] * scale)

        def f(d):
            lb = d["lb"]
            if _is_flow(lb):
                lb = _resize_flow_nearest(np.asarray(lb), w, h)
                if self.scale_mv:
                    lb = lb * scale
            else:
                lb = lb.resize((w, h), _image().NEAREST)
            return dict(im=d["im"].resize((w, h), _image().BILINEAR), lb=lb)

        return tuple(f(d) for d in parties)


class PairRandomCrop(RandomCrop):
    def __call__(self, *parties):
        im = parties[0]["im"]
        if tuple(self.size) == im.size:
            return parties
        resize, crop = self._params(*im.size)

        def f(d):
            i, lb = d["im"], d["lb"]
            if _is_flow(lb):
                lb = np.asarray(lb)
                if resize:
                    i = i.resize(resize, _image().BILINEAR)
                    lb = _resize_flow_nearest(lb, *resize)
                lb = lb[crop[1] : crop[3], crop[0] : crop[2], :]
                return dict(im=i.crop(crop), lb=lb)
            if resize:
                i = i.resize(resize, _image().BILINEAR)
                lb = lb.resize(resize, _image().NEAREST)
            return dict(im=i.crop(crop), lb=lb.crop(crop))

        return tuple(f(d) for d in parties)


# reference-name aliases: the OF/triple families are the same N-ary ops
PairOFHorizontalFlip = PairHorizontalFlip
PairOFRandomScaleV2 = PairRandomScale
PairOFRandomCrop = PairRandomCrop
TripleColorJitter = PairColorJitter
TripleOFHorizontalFlip = PairHorizontalFlip
TripleOFRandomScaleV2 = PairRandomScale
TripleOFRandomCrop = PairRandomCrop


class PairOFRandomScale(PairRandomScale):
    """V1: flow resize without magnitude rescale (transform.py:263-289)."""

    def __init__(self, scales=(1,), rng=None):
        super().__init__(scales, rng=rng, scale_mv=False)


def normalize(img, mean, std):
    """PIL/uint8 HWC -> float32 HWC normalized (torch ToTensor+Normalize).
    In-place ops in the same order as (x/255 - mean)/std — bit-identical,
    no intermediate full-size temporaries (8 MB each at 720x960)."""
    x = np.asarray(img, dtype=np.float32)
    if x is img:  # asarray of an f32 ndarray is a view; don't mutate input
        x = x.copy()
    x /= 255.0
    x -= np.asarray(mean, np.float32)
    x /= np.asarray(std, np.float32)
    return x
