"""fhe_tpu_torch's min and max by the Alt tournament (pke/schemeswitch.py
eval_min/max_scheme_switching_alt: the selector assembled in the FHEW
domain, one FHEW -> CKKS conversion a round) on the CPU, byte-equal to
fhe_tpu's schemeswitch.py run over the port's ops and within fhe_tpu's
tests/test_schemeswitch.py bounds, on test_torch_schemeswitch_minmax.py's
context, values and cut TOY_RADIX key."""

import torch

from test_torch_schemeswitch import fhe_tpu_schemeswitch_over_the_port  # noqa: F401 (fixture)
from test_torch_schemeswitch_minmax import min_max_case, minmax  # noqa: F401 (fixture)

# One pytest-xdist worker a core: torch's intra-op thread pool in each
# worker would oversubscribe the cores and slow the whole suite.
torch.set_num_threads(1)


def test_min_max_scheme_switching_alt(minmax, fhe_tpu_schemeswitch_over_the_port):
    """test_min_max_scheme_switching_alt: min over 4 with its one-hot
    argmin, max over 2."""
    min_max_case(minmax, alt=True)
