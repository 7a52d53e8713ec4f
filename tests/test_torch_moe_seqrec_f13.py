"""A sessionrec model whose head dim has no flash kernel (not one of
``ops/flash_attention.HEAD_DIMS``) answers a query in the port, as it
does in the JAX package: ``flash_attention`` takes it on the plain route
(``flash_attention_reference``) on the CPU; on the card it zero-pads the
head dim into the kernel (``tests/test_torch_moe_seqrec_cuda.py``).

The input is the SASRec paper's width: ``d_model`` 50 with 1 head, the
history [3, 4, 5] right-padded to 16, ``predict_topk`` with k = 5 and a
zero mask, on the CPU, weights from JAX's ``init_params(PRNGKey(0))``.

Zero rows: the port's plain route gives a query row with no real key
ZERO output (the flash semantics); JAX, outside its kernel's envelope,
takes ``full_attention``, which gives such a row the uniform average of
V. Serving's rows are causal with a real key at position 0, so no row
here is fully masked and the two agree on every row; the test holds the
port to the flash semantics and compares the answers, which read the
last real position only.
"""

from __future__ import annotations

import jax
import numpy as np
import torch

from predictionio_tpu.models import seqrec as jseqrec
from predictionio_tpu_torch.models import seqrec


def test_head_dim_50_answers_as_jax_does():
    jcfg = jseqrec.SeqRecConfig(vocab=100, max_len=16, d_model=50, n_heads=1, n_layers=1,
                                mlp_mult=2)
    params = jax.tree.map(np.asarray, jseqrec.init_params(jax.random.PRNGKey(0), jcfg))
    seqs = np.zeros((1, 16), np.int32)
    seqs[0, :3] = [3, 4, 5]
    mask = np.zeros((100,), np.float32)
    js, ji = jseqrec.predict_topk(params, seqs, 5, jcfg, mask)
    tcfg = seqrec.SeqRecConfig(vocab=100, max_len=16, d_model=50, n_heads=1, n_layers=1,
                               mlp_mult=2)
    model = seqrec.SeqRec.from_state(tcfg, seqrec.params_from_jax(params), "cpu")
    ts, ti = seqrec.predict_topk(model, torch.from_numpy(seqs.astype(np.int64)), 5,
                                 torch.from_numpy(mask))
    assert np.asarray(ji)[0].tolist() == [21, 79, 88, 94, 75]
    assert ti[0].tolist() == np.asarray(ji)[0].tolist()
    # bf16 activations in both frameworks: scores agree to a few bf16 steps
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), atol=0.05)
