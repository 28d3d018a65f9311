"""One intra-op thread for torch in each of the port's test modules.

The suite runs six pytest workers on the machine's cores at once (``-n 6
--dist loadfile``); torch's default of a thread a core in each of them
oversubscribes the CPU, and six copies of a port test file then run three
to four times slower than with one torch thread each. A port test module
imports :func:`one_torch_thread`, which holds torch at one thread while its
tests run and restores the previous count after them, so the JAX
package's own test modules keep torch's default.

``test_torch_yolo.py`` keeps torch's default too: its YOLO-NAS DINO steps
compare the EMA teacher's copy of a leaf whose exact gradient is zero
(``conv3.bias``, rounding noise that AdamW scales to full steps; the
student's copy is not compared), and with one thread that copy lands
1.15e-4 from the JAX package's, over the check's 1e-4.
"""

import pytest
import torch


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    prior = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prior)
