"""vits_tpu_torch: the PyTorch + CUDA port of vits_tpu, for NVIDIA Hopper.

Same synthesis path as the JAX package, which stays the reference: text
encoder with relative-position attention, stochastic duration predictor,
duration alignment, reverse coupling flow and HiFiGAN vocoder; and the same
adversarial training path (``vits_tpu_torch.train``). The kernels of both
paths are hand-written CUDA for sm_90a (``csrc/``), built on first use; on
CPU tensors each takes its plain PyTorch version.

    model = vits_tpu_torch.load_model("voice.ggml", device="cuda")
    audio = model.synthesize("hello world")  # float32 PCM

    from vits_tpu_torch.train.loop import train
    train("corpus/", "voice.ggml", "run/", steps=1000, device="cuda")

The package imports torch and the JAX-free host modules of ``vits_tpu``
(config, io, text), never jax.
"""

from vits_tpu.config import EngineConfig, VitsConfig

__all__ = ["VitsConfig", "EngineConfig", "load_model"]


def load_model(source, engine_config=None, *, device):
    """Load a VITS model from a .ggml path/bytes or an HF directory onto ``device``.

    Returns a :class:`vits_tpu_torch.engine.synthesizer.Synthesizer`.
    """
    from vits_tpu_torch.engine.synthesizer import Synthesizer

    return Synthesizer.load(source, engine_config=engine_config, device=device)
