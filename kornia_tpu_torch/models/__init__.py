"""Models (counterpart of ``kornia_tpu/models``). Ported so far: the
latent-diffusion dissolving model (``diffusion.py``) that
``augmentation.RandomDissolving`` builds, and the layout helpers of
``common.py`` it uses; the rest of the JAX package's models is still to
port."""
