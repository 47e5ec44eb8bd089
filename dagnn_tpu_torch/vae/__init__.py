"""The NA/BN VAE stack: the D-VAE decoder and base model (dvae.py), the
DAGNN-encoder VAE (dagnn_vae.py), the S-VAEs (svae.py), the D-VAE variants
(dvae_variants.py), and latent scoring: the sparse GP with its EI
(sparse_gp.py), BN scoring (bn_score.py) and the ENAS scorer
(enas_eval.py). Counterpart of dagnn_tpu/vae/."""

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
from dagnn_tpu_torch.vae.svae import (
    SVAEConfig,
    svae_init,
    svae_encode,
    svae_loss,
    svae_decode,
    graph_to_string_tensor,
)
from dagnn_tpu_torch.vae.dvae_variants import (
    DVAEGCNConfig,
    dvae_gcn_init,
    dvae_gcn_encode,
    dvae_gcn_loss,
    dvae_fast_init,
    dvae_fast_loss,
    DeepGMGConfig,
    deepgmg_init,
    deepgmg_encode,
    deepgmg_loss,
)
from dagnn_tpu_torch.vae.sparse_gp import (
    SparseGP,
    fit_sparse_gp,
    predict,
    log_ei,
    batched_greedy_ei,
)
from dagnn_tpu_torch.vae.enas_eval import EvalENAS, featurize_row

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
    "SVAEConfig",
    "svae_init",
    "svae_encode",
    "svae_loss",
    "svae_decode",
    "graph_to_string_tensor",
    "DVAEGCNConfig",
    "dvae_gcn_init",
    "dvae_gcn_encode",
    "dvae_gcn_loss",
    "dvae_fast_init",
    "dvae_fast_loss",
    "DeepGMGConfig",
    "deepgmg_init",
    "deepgmg_encode",
    "deepgmg_loss",
    "SparseGP",
    "fit_sparse_gp",
    "predict",
    "log_ei",
    "batched_greedy_ei",
    "EvalENAS",
    "featurize_row",
]
