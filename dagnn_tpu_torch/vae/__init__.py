"""The NA/BN VAE stack: the D-VAE decoder and base model (dvae.py), the
DAGNN-encoder VAE (dagnn_vae.py) and BN scoring (bn_score.py).
Counterpart of dagnn_tpu/vae/ for those modules."""

from dagnn_tpu_torch.vae.dvae import (
    DVAEConfig,
    dvae_decoder_init,
    dvae_base_init,
    dvae_teacher_loss,
    dvae_encode_sequential,
    dvae_decode,
    reparameterize,
    kld,
)
from dagnn_tpu_torch.vae.dagnn_vae import (
    DAGNNVAEConfig,
    dagnn_vae_init,
    dagnn_vae_encode,
    dagnn_vae_loss,
    dagnn_vae_decode,
)

__all__ = [
    "DVAEConfig",
    "dvae_decoder_init",
    "dvae_base_init",
    "dvae_teacher_loss",
    "dvae_encode_sequential",
    "dvae_decode",
    "reparameterize",
    "kld",
    "DAGNNVAEConfig",
    "dagnn_vae_init",
    "dagnn_vae_encode",
    "dagnn_vae_loss",
    "dagnn_vae_decode",
]
