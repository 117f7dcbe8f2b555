"""Parameter loading for the port.

Reading and writing checkpoints, the tokenizer and random weights are the
port's copies of the JAX package's host modules (``io/ggml.py``,
``io/loader.py``, ``io/random_init.py``, ``text/``), re-exported here;
``params.py`` turns their numpy parameters into the port's tensors.
"""

from vits_tpu_torch.io.loader import export_to_ggml, load_ggml, load_hf_pretrained
from vits_tpu_torch.io.random_init import random_params
from vits_tpu_torch.text.tokenizer import VitsTokenizer

__all__ = ["VitsTokenizer", "export_to_ggml", "load_ggml", "load_hf_pretrained",
           "random_params"]
