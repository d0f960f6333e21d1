"""repro_torch.apps — the paper's two application studies, as the tuner and
the fault campaign drive them.

Counterparts of the glue the reference's tuner and campaign import from its
benchmark folder (``benchmarks/table4_ann.py``, ``benchmarks/fig34_imaging.py``);
the port keeps its own copy, so that nothing here imports the reference:

  table4_ann.py     Table 4's classifier: the synthetic 10-class 28 x 28
                    dataset (numpy, equal to the reference's arrays), float
                    training of the 784-100(-100)-10 MLPs (torch autograd,
                    SGD with momentum, cosine learning rate) and 8-bit
                    fixed-point inference through an integer matmul
                    (``matmul_int``: the ``logmatmul`` kernel on the card)
  fig34_imaging.py  Fig. 3/4's imaging pipeline: synthetic 8-bit images,
                    the multiplicative blend and the 5 x 5 Gaussian whose
                    window sum runs on the multiplier and whose
                    normalization runs on the divider (``elemwise`` on the
                    card)

The benchmarks' own reports (their ``main``) are not ported here.
"""
from . import fig34_imaging, table4_ann

__all__ = ["fig34_imaging", "table4_ann"]
