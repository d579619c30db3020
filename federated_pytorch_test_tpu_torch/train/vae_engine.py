"""VAE and clustering-VAE trainers: engine subclasses.

Port of ``federated_pytorch_test_tpu/train/vae_engine.py``.  They override
the workload hooks of :class:`BlockwiseFederatedTrainer` only; the round
loop, the data staging and the FedAvg exchange are the engine's.  The
reparametrisation noise is the engine's draw per client and minibatch step
(``noise``); evaluation uses its fixed draw (``EVAL_NOISE_WORDS``).
"""

from __future__ import annotations

import numpy as np

from federated_pytorch_test_tpu_torch.train.engine import (
    EVAL_NOISE_WORDS,
    BlockwiseFederatedTrainer,
)
from federated_pytorch_test_tpu_torch.train.vae_losses import vae_cl_loss, vae_loss


class VAETrainer(BlockwiseFederatedTrainer):
    """Federated plain VAE (federated_vae.py):

    * the LAYER sweep (unfreeze_one_layer, federated_vae.py:129), ci over
      len(train_order_block_ids()), 12 for AutoEncoderCNN as its layers;
    * loss sum-MSE + KLD, labels ignored (federated_vae.py:96-108);
    * no L1/L2 regularisation (the model has no linear-layer ids, so the
      engine's ``reg_for_block`` gives none);
    * ``evaluate`` gives each client's mean test ELBO per sample (the
      reference prints losses only).
    """

    sweep = "layers"

    def model_loss(self, p, bs, xb, yb, wb, noise=None):
        # the sum-reduction ELBO decomposes per sample: wb weights the pad
        # rows of the last partial minibatch out
        recon, mu, logvar = self.model.apply(p, xb, noise)
        return vae_loss(recon, xb, mu, logvar, wb), bs

    def eval_batch_metric(self, p, bs, xb, yb, wb):
        recon, mu, logvar = self.model.apply(
            p, xb, self.noise(EVAL_NOISE_WORDS, xb.shape[0]))
        return vae_loss(recon, xb, mu, logvar, wb)

    def eval_finalize(self, totals: np.ndarray, n_samples: int) -> np.ndarray:
        return totals / n_samples               # mean test ELBO per sample


class VAECLTrainer(BlockwiseFederatedTrainer):
    """Federated clustering VAE (federated_vae_cl.py):

    * three blocks: encoder, decoder, latent space (simple_models.py:430-432);
    * the latent block (ci == 2) trains with Adam at lr 1e-4, the encoder
      and decoder with ``LBFGSNew`` (federated_vae_cl.py:200-205);
    * reparametrisation always on (the reference's ``disable_repr()`` is a
      no-op, simple_models.py:344-345);
    * L2 ``lambda2`` on the flat trainable vector of every block, no L1
      (federated_vae_cl.py:228-230).
    """

    def optimizer_for_block(self, ci):
        return "adam" if ci == 2 else "lbfgs"

    def lr_for_block(self, ci):
        return 1e-4                             # federated_vae_cl.py:200

    def reg_for_block(self, ci):
        return (0.0, self.cfg.lambda2)          # federated_vae_cl.py:228-230

    def model_loss(self, p, bs, xb, yb, wb, noise=None):
        # every mean-over-batch divisor of the ELBO is sum(wb), the true
        # size of a partial batch
        return vae_cl_loss(*self.model.apply(p, xb, noise), xb, w=wb), bs

    def eval_batch_metric(self, p, bs, xb, yb, wb):
        # vae_cl_loss is a mean over the batch: scale it back to a sum, so
        # that eval_finalize's division gives the mean per sample
        out = self.model.apply(p, xb,
                               self.noise(EVAL_NOISE_WORDS, xb.shape[0]))
        return vae_cl_loss(*out, xb, w=wb) * wb.sum()

    def eval_finalize(self, totals: np.ndarray, n_samples: int) -> np.ndarray:
        return totals / n_samples               # mean test ELBO per sample
