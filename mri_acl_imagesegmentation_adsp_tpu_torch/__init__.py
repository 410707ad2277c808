"""PyTorch/CUDA port of ``mri_acl_imagesegmentation_adsp_tpu``.

The JAX package beside this one is the reference; every module here names
its counterpart there by file and line, and ``tests/test_torch_*.py`` hold
each against it on the same numpy inputs. This package imports neither JAX
nor the JAX package. Entry points run on ``cuda`` unless the caller passes
``device="cpu"``; asking for ``cuda`` on a machine without a card raises.
"""
