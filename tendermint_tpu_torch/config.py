"""Device-batch bucket sizes.

Counterpart: tendermint_tpu/config.py:47 (DEFAULT_BUCKET_SIZES). 12288
exists for the 10k-validator commit: padding 10k signatures to 16384
would waste 39% of the device work, 12288 cuts that to 18%.
"""

DEFAULT_BUCKET_SIZES = (8, 32, 128, 512, 2048, 8192, 12288, 16384)
