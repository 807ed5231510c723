"""One torch intra-op thread for the port's CPU tests.

The tier-1 run puts 6 xdist workers on an 8-core machine; at torch's
default of a thread a core that is 48 compute threads, and six copies of
tests/test_torch_quantization.py's ResNet-18 QAT test run at once took
430 s each, against 57 s each with one thread a process (39 s for one
copy alone at the default). Every tests/test_torch_*.py module takes
this fixture but three: its tests run on one torch thread, and the
process's setting comes back after the module. test_torch_cuda.py runs
on the card only. test_torch_dygraph.py and test_torch_pose.py keep
torch's default thread count, because at one thread some of their
results fell outside JAX bounds that were set at the default; those
bounds are to be re-derived so that they hold at any thread count.
"""
import pytest
import torch


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
