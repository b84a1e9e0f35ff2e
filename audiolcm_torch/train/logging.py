"""Scalar and sample logging during training (`audiolcm_tpu/train/logging.py`,
the reference's AudioLogger and logger dispatch, `main.py:452-530,634-658`).

`AudioSampleLogger` always writes each sample's mel as .npy (melvmin/melvmax
clamped, (80, T) as the reference saves it) and, given a vocoder, its wav,
under <logdir>/audio/<split>_gs-<step>/; `bigvgan_vocode_fn` vocodes with the
port's BigVGAN. `TensorBoardLogger` mirrors scalars, mel figures and audio
into event files when tensorboardX (and matplotlib, for figures) can be
imported, and `WandbLogger` into a wandb run when wandb can; without the
package each prints one loud warning and does nothing. No package is added.
"""

from __future__ import annotations

import os
from typing import Callable, Optional

import numpy as np
import torch


def _warn_disabled(what: str, package: str, err: Exception) -> None:
    print(f"WARNING: {what} logging disabled — {package} unavailable "
          f"({type(err).__name__}: {err}); training metrics will only reach metrics.jsonl",
          flush=True)


def _floats(metrics: dict) -> dict:
    out = {}
    for k, v in metrics.items():
        try:
            out[k] = float(v)
        except (TypeError, ValueError):
            pass
    return out


def _mel_figure(mel_ct: np.ndarray, vmin: float, vmax: float):
    """The reference's mel figure (`main.py:465-480`): origin-low
    spectrogram with a colour bar."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig, ax = plt.subplots(figsize=(10, 4))
    im = ax.imshow(np.asarray(mel_ct), origin="lower", aspect="auto", vmin=vmin, vmax=vmax,
                   interpolation="none")
    fig.colorbar(im, ax=ax)
    ax.set_xlabel("frames")
    ax.set_ylabel("mel bins")
    return fig


class TensorBoardLogger:
    """Event files: scalars, mel figures, audio; a no-op without tensorboardX."""

    def __init__(self, logdir: str, enabled: bool = True):
        self.writer = None
        if not enabled:
            return
        try:
            from tensorboardX import SummaryWriter

            self.writer = SummaryWriter(logdir)
        except Exception as e:  # a long run silently losing TB is worse
            _warn_disabled("TensorBoard", "tensorboardX", e)

    @property
    def active(self) -> bool:
        return self.writer is not None

    def scalars(self, step: int, metrics: dict) -> None:
        if self.writer is not None:
            for k, v in _floats(metrics).items():
                self.writer.add_scalar(k, v, step)

    def mel_image(self, tag: str, mel_ct: np.ndarray, step: int, vmin: float = -5.0,
                  vmax: float = 1.5) -> None:
        if self.writer is not None:
            self.writer.add_figure(tag, _mel_figure(mel_ct, vmin, vmax), step, close=True)

    def audio(self, tag: str, wav: np.ndarray, step: int, sample_rate: int = 16000) -> None:
        """An audio summary built here from a scipy wav encode: tensorboardX's
        add_audio needs the soundfile package."""
        if self.writer is None:
            return
        import io

        from scipy.io import wavfile
        from tensorboardX.proto.summary_pb2 import Summary

        wav = np.clip(np.asarray(wav, dtype=np.float32).reshape(-1), -1.0, 1.0)
        buf = io.BytesIO()
        wavfile.write(buf, sample_rate, (wav * 32767.0).astype(np.int16))
        audio = Summary.Audio(sample_rate=sample_rate, num_channels=1, length_frames=len(wav),
                              encoded_audio_string=buf.getvalue(), content_type="audio/wav")
        self.writer._get_file_writer().add_summary(
            Summary(value=[Summary.Value(tag=tag, audio=audio)]), step)

    def flush(self) -> None:
        if self.writer is not None:
            self.writer.flush()

    def close(self) -> None:
        if self.writer is not None:
            self.writer.close()
            self.writer = None


class WandbLogger:
    """A wandb run with TensorBoardLogger's interface; a no-op without wandb."""

    def __init__(self, logdir: str, enabled: bool = True, project: str = "audiolcm_torch",
                 name: Optional[str] = None):
        self.run = None
        self._wandb = None
        if not enabled:
            return
        try:
            import wandb

            self._wandb = wandb
            run_name = name or os.path.basename(logdir)
            self.run = wandb.init(project=project, name=run_name, dir=logdir, id=run_name)
        except Exception as e:
            _warn_disabled("wandb", "wandb", e)

    @property
    def active(self) -> bool:
        return self.run is not None

    def scalars(self, step: int, metrics: dict) -> None:
        clean = _floats(metrics)
        if self.run is not None and clean:
            self.run.log(clean, step=step)

    def mel_image(self, tag: str, mel_ct: np.ndarray, step: int, vmin: float = -5.0,
                  vmax: float = 1.5) -> None:
        if self.run is None:
            return
        import matplotlib.pyplot as plt

        fig = _mel_figure(mel_ct, vmin, vmax)
        self.run.log({tag: self._wandb.Image(fig)}, step=step)
        plt.close(fig)

    def audio(self, tag: str, wav: np.ndarray, step: int, sample_rate: int = 16000) -> None:
        if self.run is not None:
            wav = np.clip(np.asarray(wav, dtype=np.float32).reshape(-1), -1.0, 1.0)
            self.run.log({tag: self._wandb.Audio(wav, sample_rate=sample_rate)}, step=step)

    def flush(self) -> None:
        pass  # wandb streams on its own

    def close(self) -> None:
        if self.run is not None:
            self.run.finish()
            self.run = None


def make_logger(backend: str, logdir: str, enabled: bool = True):
    """"tensorboard" (the default; "testtube" and "" too) or "wandb"; an
    unknown backend warns and falls back to TensorBoard."""
    if backend == "wandb":
        return WandbLogger(logdir, enabled=enabled)
    if backend not in ("tensorboard", "testtube", ""):
        print(f"WARNING: unknown logger backend {backend!r}; falling back to tensorboard",
              flush=True)
    return TensorBoardLogger(logdir, enabled=enabled)


def bigvgan_vocode_fn(vocoder) -> Callable[[np.ndarray], np.ndarray]:
    """(B, T, 80) numpy mels -> (B, 256*T) numpy wavs through the port's
    BigVGAN, on its device and in its dtype."""
    p = next(vocoder.parameters())

    def vocode(mels: np.ndarray) -> np.ndarray:
        with torch.inference_mode():
            mel = torch.from_numpy(np.ascontiguousarray(mels, dtype=np.float32))
            return vocoder(mel.to(device=p.device, dtype=p.dtype)).float().cpu().numpy()

    return vocode


class AudioSampleLogger:
    def __init__(self, logdir: str, vocode_fn: Optional[Callable] = None,
                 sample_rate: int = 16000, max_items: int = 8, melvmin: float = -5.0,
                 melvmax: float = 1.5, tb: Optional[TensorBoardLogger] = None):
        self.root = os.path.join(logdir, "audio")
        self.vocode_fn = vocode_fn
        self.sample_rate, self.max_items = sample_rate, max_items
        self.melvmin, self.melvmax = melvmin, melvmax
        self.tb = tb

    def __call__(self, mels_btc: np.ndarray, step: int, split: str = "train",
                 names=None) -> str:
        """mels_btc (B, T, 80) -> the output directory."""
        from audiolcm_torch.api import _write_wav

        outdir = os.path.join(self.root, f"{split}_gs-{step:09d}")
        os.makedirs(outdir, exist_ok=True)
        mels = np.asarray(mels_btc)[: self.max_items]
        name = lambda i: names[i] if names else f"sample_{i}"
        for i, mel in enumerate(np.clip(mels, self.melvmin, self.melvmax)):
            np.save(os.path.join(outdir, f"{name(i)}.npy"), mel.T)
            if self.tb is not None:
                self.tb.mel_image(f"{split}/mel_{name(i)}", mel.T, step, vmin=self.melvmin,
                                  vmax=self.melvmax)
        if self.vocode_fn is not None:
            for i, wav in enumerate(np.asarray(self.vocode_fn(mels))):
                _write_wav(os.path.join(outdir, f"{name(i)}.wav"), wav, self.sample_rate)
                if self.tb is not None:
                    self.tb.audio(f"{split}/audio_{name(i)}", wav, step, self.sample_rate)
        if self.tb is not None:
            self.tb.flush()
        return outdir
