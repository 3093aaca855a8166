"""The exact-f32 products on the card, each called alone through its
wrapper: the input projection (``bigru.simt_projection``), dx
(``bigru_vjp.k5_dx``) and the weight and bias gradients
(``bigru_vjp.k5_weight_grads``), all on csrc/rnn_train_gemm.cuh's
f32_tma_kernel, held to sha256 digests taken on the parent tree's kernels
(proj_f32_kernel and gemm_f32_kernel, cp.async rings) at ragged shapes: row
counts no multiple of a tile, G = 96 (H = 32), every layer-0 width C = 11,
21, 28, 52 (X by plain loads at 11 and 21, by TMA at 28 and 52) and C =
512, several weight-gradient slices (S > 1), both cells. Needs a CUDA
device and skips without one.

This file imports no JAX:
    python -m pytest --noconftest -m cuda tests/test_torch_f32_products_cuda.py
The digests of a tree print with
    python -c "import sys; sys.path[:0] = ['.', 'tests']; import test_torch_f32_products_cuda as t; t.print_digests()"
from that tree's root (``tests`` being this file's directory).
"""

import hashlib

import numpy as np
import pytest
import torch

from ccsmeth_tpu_torch.models.rnn import init_rnn_params, layer_weights
from ccsmeth_tpu_torch.ops import bigru, bigru_vjp

# (cell, L, N, H, C): L N rows = 1,055 (8 tiles of 128 and 31 rows; 9 of
# 112 and 47) and 1,041
CASES = ([(cell, 5, 211, 32, cin) for cell in ("gru", "lstm") for cin in (11, 21, 28, 52, 512)]
         + [(cell, 3, 347, 256, cin) for cell in ("gru", "lstm") for cin in (21, 512)])


def _sha(ts):
    h = hashlib.sha256()
    for t in ts:
        h.update(t.contiguous().cpu().view(torch.uint8).numpy().tobytes())
    return h.hexdigest()


def product_digests(cell, L, N, hidden, cin):
    """sha256 of xg, of dx and of the weight and bias gradients on one case,
    each product called alone on seeded inputs; and the weight gradients'
    slice count S."""
    rng = np.random.RandomState(L * N + cin + hidden)
    (wih, bih, whh, bhh), = [layer_weights(ld, torch.float32, "cuda")
                             for ld in init_rnn_params(rng, cin, hidden, 1, cell)]
    plan = bigru_vjp.k45_plan(hidden, torch.float32, cell)
    G = plan["gates"] * hidden

    def randn(*shape):
        return torch.from_numpy(rng.randn(*shape).astype(np.float32)).cuda()

    x = randn(L, N, cin)
    xg = bigru.simt_projection(x.reshape(L * N, cin), wih, bih, bhh, cell)
    dxg = randn(2, L * N, G)
    dhg = randn(2, L * N, G) if cell == "gru" else dxg
    out = randn(L, N, 2 * hidden)
    dx = bigru_vjp.k5_dx(dxg, wih, plan, torch.float32)
    grads = bigru_vjp.k5_weight_grads(x, out, dxg, dhg, plan, torch.float32)
    S = bigru_vjp.k5_wgrad_slices(L * N, cin, hidden, torch.cuda.get_device_properties(
        0).multi_processor_count, plan["gates"])
    return _sha([xg]), _sha([dx]), _sha(grads), S


def print_digests():
    """Each case's digests, as the dict below holds them."""
    for case in CASES:
        print("    {!r}: {!r},".format(case, product_digests(*case)), flush=True)


# ``product_digests(*case)``, taken on an H100 from the parent tree
# (proj_f32_kernel and gemm_f32_kernel), before the products moved to
# f32_tma_kernel
F32_RAGGED_DIGESTS = {
    ('gru', 5, 211, 32, 11): ('3aeb85f8bbd068e18c73b684b2de51b435959db59050500a737d263b54073345', 'e860a2436c9ae257d7c80282ff65ea4a8b2d7406ecdfb9e151f724d7c7956a8f', '5d2a8e6ca825817768d592fddf3898d5ed35315d6b0e9ca54b0ea6ecc7fa6117', 4),
    ('gru', 5, 211, 32, 21): ('540b6a338550add4a87254de5b99f9f8560498b81550c1e13ad83bbd79a016ab', 'f50eaa51139cc6c03865b50239c63ebdad4014dc1871d9e51e68995a541a6dfc', '811ee9808d6690d668e0fd4ff4fbf0c048f10b36d72650f177fd27167de0bf20', 4),
    ('gru', 5, 211, 32, 28): ('a0500a73cd59e690e6a096d11d405d60e19044b296aebafb50196f50d1cdd7ec', '8aa4483dad8e62af402f65861e8756837e15fb176a3f8b64100b07c4d57053f5', '55b03cbd0b70c3e807eced5969685063c8454fe7dd4c2081054ee0078f4a7de8', 4),
    ('gru', 5, 211, 32, 52): ('41b1e971b955d2fc1331d00205801f63691db6c43f5fd033bc40a4480d355ea0', '0c015bbb1966974bcd91753dc203e06e92274be0dbdc7ef00f893a2163ba2b14', '4c0ec60c27e58ba8f28e252622e238186c5451570da2a78a312e003faaef313c', 4),
    ('gru', 5, 211, 32, 512): ('f795589118584edd89f6bb840076e30bb84b2272c5e848baac754999ea329ca9', '731fb8d0a910289f30c5007eea7da3a58bd68f5b2ec057fd846056871b365e17', '2d6239f189e9c39e5479a22ddfacc30a1e37d9e449d0cf5959b3b3aa38ebc957', 4),
    ('lstm', 5, 211, 32, 11): ('28d96628f4c765486fd750420258c71e145977db21f53a521bccf3d1a345600e', '42e81f025668f692a7c1387f0606a9002800739ffaf85cdb909f7a6f1822d7dd', '58c32793795cb34b061ef5587b4b22b2d36345dc5d14588a7088511735bb9fba', 4),
    ('lstm', 5, 211, 32, 21): ('c3102112229b8e4f4ecf144adb5a2c419fadb62b2288f184af51a94b0586ae0c', '3b7589ade1b9adaa43ce35d0127878eed28825449cc8f8a7ff0d5f804800f450', '33f182c6657fe00c4be63fb5ac9b4d3e01a5917756fb214f7b6d7da96c1232e6', 4),
    ('lstm', 5, 211, 32, 28): ('9e46bbd1679ff9dbf3bd72e94f09446548ecb460bc93c6df93c21ee83f6395d5', 'a7243fbf2cb50dc882276b49d78c8a19255b55ad22a8d33c9355554dd65afd7e', 'd95514bda6236707c534a89ac6cd710db0bdb8f420c86a05a714d002648be1e1', 4),
    ('lstm', 5, 211, 32, 52): ('0f03d5cf712afb297435e2f19f8a681b10b241062e7d7af4942a0d54c945a02d', '78aeba9f8cbd5a59478ce03e025c8e64f5b1eefd622a534daa1bc57a0d30cfc9', '148c6ce3665cf45c1475100ede477c6daa44cecb62179048e23a41604dc5e334', 4),
    ('lstm', 5, 211, 32, 512): ('8a15f01563552e013fb71094db4659bc3b9828949c0ccd2a549b4bb7285fd61a', 'd103a19ca4a5588f9f6e281022335acac33cfe8e041f7d0d5c3cd06350a10c31', '134887b09440995b7b3d5983d5ec7c66016cc15c0aae2a5e0faf14a917e4ed18', 4),
    ('gru', 3, 347, 256, 21): ('f9201e6096caf639012f8010ec581625640a7ce15670d1a74b117b2cac6955eb', '50a667696a6d7719f7559bfe1b986c7c0f5946db2c1a042895c43545b8a73885', '24d98cf4749015a1c8d7e58c94ecafadc32c3029608d1f082ba0b3dd3a6502ab', 4),
    ('gru', 3, 347, 256, 512): ('f2dad3f25bb0085f9c48882404c88bbd7d7448b47de17d01dbba879b92850be8', '4759186771701dc664e1cdb2ce9e97555f8fef810a951e6b5f26bbf4b5c60181', '579d3294b6a010dbb067acee68ce8f82cc5c4d4292db64ca50d37658b13d3551', 3),
    ('lstm', 3, 347, 256, 21): ('651b2bd2328b15abe4acfc7848ec96137ddf43896543fd22d5fc3da59b5ae30a', '4bc3a71102aac2273fd87258800225736fcf304e33e236cc3d626e0565b8ef49', '158615af27019e4d320fbe81efddcb63f7979dc33dd3f932cfdf1c600661326e', 4),
    ('lstm', 3, 347, 256, 512): ('4a912302d4e844d15d39dfeef2912a88b104923d31a2943cdc45e6a843287092', '99e37cd9310cde470f7a3dcecd76e0fb7ee8c2cc6ef0fb67b726519f8cf6d9d1', 'ecced4336dd962e6f33529ca406a216a60db408e927c72ea95d3375797ba4a11', 2),
}


@pytest.mark.cuda
@pytest.mark.parametrize("case", CASES)
def test_f32_products_bit_equal_to_the_parent_digests(case):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    assert bigru_vjp.k45_plan(case[3], torch.float32, case[0])["design"] == "simt"
    got = product_digests(*case)
    assert got[3] > 1 or case[3] == 256, got  # the H = 32 cases take several slices
    assert got == F32_RAGGED_DIGESTS[case]
