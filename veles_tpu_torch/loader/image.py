"""Image loaders with augmentation.

Counterpart of ``veles_tpu/loader/image.py``: scale / crop / rotate /
mirror augmentation, color space conversion
(:mod:`veles_tpu_torch.loader.colorspace`), directory-scanning file
loaders, and a full-batch composition that puts the whole image set on
the device.  Augmentation happens on the host when the data loads
(``cv2``, imported then); each minibatch is then one
``gather_minibatch`` launch on the card.
"""

import os

import numpy

from veles_tpu_torch.loader.base import LoaderError, TRAIN
from veles_tpu_torch.loader.fullbatch import (FullBatchLoader,
                                              FullBatchLoaderMSE)

__all__ = ["ImageAugmentation", "FullBatchImageLoader",
           "FileImageLoader", "FullBatchImageLoaderMSE",
           "FileImageLoaderMSE", "scan_image_tree"]

IMAGE_EXTENSIONS = (".png", ".jpg", ".jpeg", ".bmp", ".ppm", ".pgm",
                    ".tif", ".tiff", ".webp")


class ImageAugmentation(object):
    """scale: output (w, h); crop: (w, h) random window; mirror:
    False | True (random) | "always"; rotations: list of degrees to
    sample from; color_space: target space name from
    :data:`veles_tpu_torch.loader.colorspace.SPACES` (e.g. "GRAY", "HSV",
    "YCR_CB"); the source is what the reader produced (BGR for color
    cv2.imread, override with ``apply(img, source_space=...)``)."""

    def __init__(self, scale=None, crop=None, mirror=False,
                 rotations=(0,), color_space=None, prng=None):
        from veles_tpu_torch import prng as prng_module
        self.scale = scale
        self.crop = crop
        self.mirror = mirror
        self.rotations = tuple(rotations)
        self.color_space = color_space
        self.prng = prng or prng_module.get("image_augmentation")

    def apply(self, img, source_space="BGR"):
        import cv2

        from veles_tpu_torch.loader import colorspace
        if self.color_space:
            img = colorspace.convert(img, source_space,
                                     self.color_space)
        if self.scale:
            img = cv2.resize(img, tuple(self.scale),
                             interpolation=cv2.INTER_AREA)
        if len(self.rotations) > 1 or self.rotations[0]:
            angle = self.rotations[int(
                self.prng.random_sample() * len(self.rotations))]
            if angle:
                h, w = img.shape[:2]
                mat = cv2.getRotationMatrix2D((w / 2, h / 2), angle, 1.0)
                img = cv2.warpAffine(img, mat, (w, h))
        if self.crop:
            cw, ch = self.crop
            h, w = img.shape[:2]
            if h < ch or w < cw:
                raise LoaderError("crop %s larger than image %s" %
                                  ((cw, ch), (w, h)))
            x0 = int(self.prng.random_sample() * (w - cw + 1))
            y0 = int(self.prng.random_sample() * (h - ch + 1))
            img = img[y0:y0 + ch, x0:x0 + cw]
        if self.mirror == "always" or (
                self.mirror is True and self.prng.random_sample() < 0.5):
            img = img[:, ::-1]
        return numpy.ascontiguousarray(img)


def scan_image_tree(root_dir):
    """directory-per-class tree -> sorted [(path, label), ...]."""
    samples = []
    for label in sorted(os.listdir(root_dir)):
        class_dir = os.path.join(root_dir, label)
        if not os.path.isdir(class_dir):
            continue
        for fname in sorted(os.listdir(class_dir)):
            if fname.lower().endswith(IMAGE_EXTENSIONS):
                samples.append((os.path.join(class_dir, fname), label))
    return samples


def distortion_stages(mirror, rotations):
    """The deterministic distortion composition: every (mirror,
    rotation) combination, materialized."""
    stages = []
    for rot in rotations:
        stages.append((False, rot))
        if mirror is True or mirror == "always":
            stages.append((True, rot))
    return stages


def distort(img, mirror_state, rotation):
    """Apply one deterministic distortion stage."""
    import cv2
    if rotation:
        h, w = img.shape[:2]
        mat = cv2.getRotationMatrix2D((w / 2, h / 2), rotation, 1.0)
        img = cv2.warpAffine(img, mat, (w, h))
        if img.ndim == 2:
            img = img[..., None]
    if mirror_state:
        img = img[:, ::-1]
    return numpy.ascontiguousarray(img)


class FullBatchImageLoader(FullBatchLoader):
    """Loads explicit (path, label) lists per split into one device
    batch.

    kwargs: test_paths / validation_paths / train_paths: lists of
    (path, label); augmentation: ImageAugmentation; grayscale: bool;
    color_space: target space from colorspace.SPACES (None keeps the
    reader's space — BGR for color files, GRAY with grayscale=True);
    distortion composition via mirror=True + rotations=(0, 15, -15):
    every TRAIN sample is materialized once per (mirror, rotation)
    combination (samples_inflation).
    """

    def __init__(self, workflow, **kwargs):
        super(FullBatchImageLoader, self).__init__(workflow, **kwargs)
        self.split_paths = (kwargs.get("test_paths", ()),
                            kwargs.get("validation_paths", ()),
                            kwargs.get("train_paths", ()))
        self.augmentation = kwargs.get("augmentation")
        self.grayscale = kwargs.get("grayscale", False)
        self.color_space = kwargs.get("color_space")
        self.mirror = kwargs.get("mirror", False)
        self.rotations = tuple(kwargs.get("rotations", (0,)))

    @property
    def samples_inflation(self):
        """How many distorted copies each TRAIN sample becomes."""
        return len(distortion_stages(self.mirror, self.rotations))

    def _read_image(self, path):
        import cv2
        flag = cv2.IMREAD_GRAYSCALE if self.grayscale \
            else cv2.IMREAD_COLOR
        img = cv2.imread(path, flag)
        if img is None:
            raise LoaderError("cannot read image %s" % path)
        space = "GRAY" if self.grayscale else "BGR"
        if self.augmentation is not None:
            img = self.augmentation.apply(img, source_space=space)
            space = self.augmentation.color_space or space
        if self.color_space and self.color_space != space:
            from veles_tpu_torch.loader import colorspace
            img = colorspace.convert(img, space, self.color_space)
        if img.ndim == 2:
            img = img[..., None]
        return img

    def _expanded_splits(self):
        """(path, label, mirror_state, rotation) rows per split;
        TRAIN inflated by the distortion composition."""
        stages = distortion_stages(self.mirror, self.rotations)
        out = []
        for cls, split in enumerate(self.split_paths):
            rows = []
            for path, label in split:
                if cls == TRAIN and len(stages) > 1:
                    for mirror_state, rot in stages:
                        rows.append((path, label, mirror_state, rot))
                else:
                    rows.append((path, label, False, 0))
            out.append(rows)
        return out

    def load_data(self):
        splits = self._expanded_splits()
        for i, rows in enumerate(splits):
            self.class_lengths[i] = len(rows)
        self._calc_class_end_offsets()
        flat = [row for rows in splits for row in rows]
        first = self._read_image(flat[0][0])
        self.create_originals(first.shape)
        for i, (path, label, mirror_state, rot) in enumerate(flat):
            img = self._read_image(path)
            if img.shape != first.shape:
                raise LoaderError(
                    "image %s shape %s != %s (use augmentation.scale)" %
                    (path, img.shape, first.shape))
            if mirror_state or rot:
                img = distort(img, mirror_state, rot)
            self.original_data.mem[i] = img.astype(self.dtype) / 255.0
            self.original_labels[i] = label


class FileImageLoader(FullBatchImageLoader):
    """Scans directory trees: test_dir / validation_dir / train_dir
    each holding class subdirectories."""

    def __init__(self, workflow, **kwargs):
        dirs = [kwargs.get("test_dir"), kwargs.get("validation_dir"),
                kwargs.get("train_dir")]
        paths = tuple(scan_image_tree(d) if d else () for d in dirs)
        kwargs["test_paths"], kwargs["validation_paths"], \
            kwargs["train_paths"] = paths
        super(FileImageLoader, self).__init__(workflow, **kwargs)


class FullBatchImageLoaderMSE(FullBatchImageLoader, FullBatchLoaderMSE):
    """(input image, target image) pairs for MSE workflows.

    Target sources, either of:
    - ``target_paths``: one target image path per sample, ordered like
      test_paths + validation_paths + train_paths (label-less MSE);
    - ``class_target_paths``: {label: path} — one target image per
      class; each sample's target is its class's image.
    """

    def __init__(self, workflow, **kwargs):
        super(FullBatchImageLoaderMSE, self).__init__(workflow, **kwargs)
        self.target_paths = list(kwargs.get("target_paths", ()))
        self.class_target_paths = dict(
            kwargs.get("class_target_paths", {}))
        if bool(self.target_paths) == bool(self.class_target_paths):
            raise LoaderError(
                "provide exactly one of target_paths / "
                "class_target_paths")

    def load_data(self):
        super(FullBatchImageLoaderMSE, self).load_data()
        if self.class_target_paths:
            targets_by_label = {
                label: self._read_image(path).astype(self.dtype) / 255.0
                for label, path in self.class_target_paths.items()}
            self.original_targets = numpy.stack(
                [targets_by_label[label]
                 for label in self.original_labels])
            return
        # per-sample targets follow the same distortion composition as
        # the inputs so pairs stay aligned
        splits = self._expanded_splits()
        flat_inputs = [row for rows in splits for row in rows]
        if len(self.target_paths) != sum(
                len(s) for s in self.split_paths):
            raise LoaderError(
                "%d target_paths for %d source images" %
                (len(self.target_paths),
                 sum(len(s) for s in self.split_paths)))
        target_by_source = {}
        flat_sources = [pair[0] for split in self.split_paths
                        for pair in split]
        for src, tgt in zip(flat_sources, self.target_paths):
            target_by_source[src] = tgt
        targets = []
        for path, _label, mirror_state, rot in flat_inputs:
            img = self._read_image(target_by_source[path])
            if mirror_state or rot:
                img = distort(img, mirror_state, rot)
            targets.append(img.astype(self.dtype) / 255.0)
        self.original_targets = numpy.stack(targets)


class FileImageLoaderMSE(FullBatchImageLoaderMSE):
    """Directory-scanning MSE variant: target_dir holds one image per
    source basename."""

    def __init__(self, workflow, **kwargs):
        dirs = [kwargs.get("test_dir"), kwargs.get("validation_dir"),
                kwargs.get("train_dir")]
        paths = tuple(scan_image_tree(d) if d else () for d in dirs)
        kwargs["test_paths"], kwargs["validation_paths"], \
            kwargs["train_paths"] = paths
        target_dir = kwargs.get("target_dir")
        if target_dir and "target_paths" not in kwargs:
            kwargs["target_paths"] = [
                os.path.join(target_dir, os.path.basename(p))
                for split in paths for (p, _label) in split]
        super(FileImageLoaderMSE, self).__init__(workflow, **kwargs)
