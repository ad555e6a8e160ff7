"""numpy's BLAS on one thread while a port test file runs.

The suite runs in several worker processes (`-n 6`), and OpenBLAS starts
a thread for each core in every worker. On the small matrices of these
tests (the pseudo-inverses of the spectral tables above all) those threads
mostly wait for one another: with every core busy, one thread does the
same work many times faster. Each port test file imports
:func:`one_blas_thread`, which holds the BLAS libraries of numpy and scipy
to one thread while the file's tests run and gives them back their thread
count afterwards, so a test file run after it on the same worker sees the
default. The port's tests need threadpoolctl for it: without the package
they fail to import, and do not run slower unseen.
"""

import pytest
from threadpoolctl import threadpool_limits


@pytest.fixture(scope="module", autouse=True)
def one_blas_thread():
    with threadpool_limits(limits=1, user_api="blas"):
        yield
