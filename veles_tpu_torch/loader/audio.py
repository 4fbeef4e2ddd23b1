"""Audio file loader.

Counterpart of ``veles_tpu/loader/audio.py``: decodes WAV through
``scipy.io.wavfile`` (or the standard library's ``wave`` where scipy is
missing), scales to float32 [-1, 1], and serves fixed-length mono
windows as samples.  A ``FullBatchLoader``: on the card each minibatch
is one ``gather_minibatch`` launch.
"""

import os
import wave

import numpy

from veles_tpu_torch.loader.base import LoaderError
from veles_tpu_torch.loader.fullbatch import FullBatchLoader

__all__ = ["read_audio", "AudioFileLoader"]

AUDIO_EXTENSIONS = (".wav", ".wave")


def read_audio(path):
    """-> (float32 samples in [-1, 1] shaped (frames, channels), rate)."""
    try:
        from scipy.io import wavfile
        rate, data = wavfile.read(path)
    except ImportError:  # pragma: no cover - scipy is baked in
        with wave.open(path, "rb") as wav:
            rate = wav.getframerate()
            frames = wav.readframes(wav.getnframes())
            width = wav.getsampwidth()
            dtype = {1: numpy.uint8, 2: numpy.int16,
                     4: numpy.int32}[width]
            data = numpy.frombuffer(frames, dtype).reshape(
                -1, wav.getnchannels())
    if data.ndim == 1:
        data = data[:, None]
    if data.dtype == numpy.uint8:
        out = (data.astype(numpy.float32) - 128.0) / 128.0
    elif numpy.issubdtype(data.dtype, numpy.integer):
        out = data.astype(numpy.float32) / float(
            numpy.iinfo(data.dtype).max)
    else:
        out = data.astype(numpy.float32)
    return out, rate


class AudioFileLoader(FullBatchLoader):
    """Scans a directory-per-class tree of audio files; each sample is
    one ``window_frames``-long mono window (files are averaged across
    channels and chopped; short files are zero-padded).

    kwargs: train_dir / validation_dir / test_dir, window_frames
    (default 1024), stride_frames (default = window).
    """

    def __init__(self, workflow, **kwargs):
        super(AudioFileLoader, self).__init__(workflow, **kwargs)
        self.dirs = (kwargs.get("test_dir"),
                     kwargs.get("validation_dir"),
                     kwargs.get("train_dir"))
        self.window_frames = int(kwargs.get("window_frames", 1024))
        self.stride_frames = int(
            kwargs.get("stride_frames", self.window_frames))
        self.sampling_rate = None

    def _scan(self, base):
        out = []
        if not base:
            return out
        for label in sorted(os.listdir(base)):
            cdir = os.path.join(base, label)
            if not os.path.isdir(cdir):
                continue
            for fname in sorted(os.listdir(cdir)):
                if fname.lower().endswith(AUDIO_EXTENSIONS):
                    out.append((os.path.join(cdir, fname), label))
        return out

    def _windows(self, path):
        data, rate = read_audio(path)
        if self.sampling_rate is None:
            self.sampling_rate = rate
        elif rate != self.sampling_rate:
            raise LoaderError(
                "%s sampling rate %d != %d" %
                (path, rate, self.sampling_rate))
        mono = data.mean(axis=1)
        if len(mono) < self.window_frames:
            mono = numpy.pad(mono,
                             (0, self.window_frames - len(mono)))
        wins = []
        for start in range(
                0, len(mono) - self.window_frames + 1,
                self.stride_frames):
            wins.append(mono[start:start + self.window_frames])
        return wins

    def load_data(self):
        splits = [self._scan(d) for d in self.dirs]
        data, labels, lengths = [], [], []
        for files in splits:
            count = 0
            for path, label in files:
                for win in self._windows(path):
                    data.append(win)
                    labels.append(label)
                    count += 1
            lengths.append(count)
        if not data:
            raise LoaderError("no audio samples found")
        self.original_data = numpy.stack(data).astype(self.dtype)
        self.original_labels = labels
        self.class_lengths[:] = lengths
