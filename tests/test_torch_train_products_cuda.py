"""The fp32 (simt) backward products of K5 and K6 on the card: dx and the
weight and bias gradients (csrc/rnn_train_gemm.cuh's exact-f32 product
kernel, reached through bigru_train.cu's k5_dx_launch and k5_wgrad_launch)
held to sha256 digests taken on the parent tree, before the products moved
off gemm_simt_kernel, at shapes the older digests miss: 1,024 and 4,096 rows
at H = 256 with C = 11, 28, 52 and 512 (several slices and waves of the
weight-gradient launch), and H = 32, 64, 128 at C = 21. Needs a CUDA device
and skips without one.

This file imports no JAX:
    python -m pytest --noconftest -m cuda tests/test_torch_train_products_cuda.py
The digests of a tree print with
    python -c "import sys; sys.path[:0] = ['.', 'tests']; import test_torch_train_products_cuda as t; t.print_digests()"
from that tree's root (``tests`` being this file's directory).
"""

import hashlib

import numpy as np
import pytest
import torch

from ccsmeth_tpu_torch.models.rnn import init_rnn_params, layer_weights
from ccsmeth_tpu_torch.ops import bigru_vjp, bilstm_vjp

CASES = ([(cell, rows, 256, cin) for cell in ("gru", "lstm") for rows in (1024, 4096)
          for cin in (11, 28, 52, 512)]
         + [(cell, 512, hidden, 21) for cell in ("gru", "lstm") for hidden in (32, 64, 128)])


def _case(cell, rows, hidden, cin):
    rng = np.random.RandomState(7 + rows + cin + hidden)
    (wih, bih, whh, bhh), = [layer_weights(ld, torch.float32, "cuda")
                             for ld in init_rnn_params(rng, cin, hidden, 1, cell)]
    x = torch.from_numpy(rng.randn(21, rows, cin).astype(np.float32)).cuda()
    dout = torch.from_numpy(rng.randn(21, rows, 2 * hidden).astype(np.float32)).cuda()
    return x, wih, bih, whh, bhh, dout


def _sha(ts):
    h = hashlib.sha256()
    for t in ts:
        h.update(t.contiguous().cpu().view(torch.uint8).numpy().tobytes())
    return h.hexdigest()


def train_digests(cell, rows, hidden, cin):
    """sha256 over the fp32 forward's outputs and, apart, over the
    backward's five gradients on one case: (forward, backward)."""
    x, wih, bih, whh, bhh, dout = _case(cell, rows, hidden, cin)
    if cell == "gru":
        res = bigru_vjp.bigru_layer_train_fwd(x, wih, bih, whh, bhh, torch.float32)
        grads = bigru_vjp.bigru_layer_bwd(dout, x, wih, whh, *res, torch.float32)
    else:
        res = bilstm_vjp.bilstm_layer_train_fwd(x, wih, bih, whh, bhh, torch.float32)
        grads = bilstm_vjp.bilstm_layer_bwd(dout, x, wih, whh, *res, torch.float32)
    return _sha(res), _sha(grads)


def print_digests():
    """Each case's digests, as the dict below holds them."""
    for case in CASES:
        print("    {!r}: {!r},".format(case, train_digests(*case)), flush=True)


# ``train_digests(*case)``, taken on an H100 from the parent tree (fp32
# products on gemm_simt_kernel, the projection on proj_f32_kernel)
PRODUCT_DIGESTS = {
    ('gru', 1024, 256, 11): ('03a07295e7cabf27229193370c97024a7635100b2a24fb78a5df1570407cd275', 'afdf31bb4a415d6e4655a72268438b49aad30383969edc6ccfc1e6d381ab8d6f'),
    ('gru', 1024, 256, 28): ('a58ffccec988b901b168d326bae64654a35843c3dffec5a8e8171ce64eccb67d', 'dcd944b0b19014e67f1d66e12844a7a01ea003ddc6aee33bb2e393910f3bf8d9'),
    ('gru', 1024, 256, 52): ('9a61313b2e4c96cc350509f4c07d522cc7adbd6d196a9f8722bb6ebf30c99bb2', 'e6b658aec60f079eb325221da5c74c84b8003f255300cac405d1adba4d8c362d'),
    ('gru', 1024, 256, 512): ('620a193465eaf5fc84ece4865661718171c21912c1e0f5edc9af2d2dfd257484', '518542c37ca96866825c39d45e6acc99080e88e28d8d40129ba598ab3d4d4493'),
    ('gru', 4096, 256, 11): ('541daae4fced0e412fc333a6163ca2092db3e66bded359eefef9eb8db373e5c3', 'b3c2115986c63ba6175d21ccd2e2b1bb17b2d2677b2247d57b6675a15938f9e5'),
    ('gru', 4096, 256, 28): ('654f427207d973e72a88a679e562b602a068447873f5f3b4a3008cb6a357e552', '544706c0c70e4226640ba301090b2069e9aa9f48bff3908de4f69bbe89bd8d43'),
    ('gru', 4096, 256, 52): ('cb0d01cc4d06e415bfb7e4ddcbdcfd548658a83b0537c6fb1dbcd6330dbdb551', '79b65f32355af571703ae915235f52a0f8aebc5f50242a502a918cdba5f6433e'),
    ('gru', 4096, 256, 512): ('3eb1f9b33d35d4dd112b87ab1f3ffcd8c170e5e9ffb9b97f0bc3f0a8835a7cff', 'b2b47deea779c266e7f07849b80067b2206b0f42fb26c465785e5cfc6800c86b'),
    ('lstm', 1024, 256, 11): ('dbc1bb344f87caacbf481f926accf8b0250cf6ec7523f92dc70cff4d2196521e', 'bcda6207bf0ab9b0a06b065083bbe893da4dd719b461a876494993deb06067d8'),
    ('lstm', 1024, 256, 28): ('b81cfff7ba34f8dff638ffb1a931ef53c68d718e7fea61b5fb8b3c15170c49e5', '34c7c17ed51c7c5135011a3e337eae86f48a0738506f34c91e6f36d71cd3704f'),
    ('lstm', 1024, 256, 52): ('4d55caf63dd0cfd414e14161520fcd4e041c78bc18803a78021e2869ce2e2eb9', 'f291a35c14e089ec07bb89fd7ecd13fd75f2bea0c225335d86a26d5a4d869b22'),
    ('lstm', 1024, 256, 512): ('f105d11b07e239b47b384cb3cf7475b498f8cb6d21fd93444fd157e77cb0463a', '3489e361d9c4594d7945dba8ae19143d7f6550fcd43eb647c78a2875a05ed5fe'),
    ('lstm', 4096, 256, 11): ('801084e4d4dc40a3211e3284ddaca16605115c6b7effa56e242e5c5d7aa8c207', '4a55bd6c2414ad0632097ad1473b84104dcfa03467d303924ae627b58dba5877'),
    ('lstm', 4096, 256, 28): ('54f5d468bf4056102c9f092d8e114120246e4232c43f25a2f4289b9c14075158', 'f0c713a356995a85536e15fa1fd3a25e688ef0fbed401d1c98b7efd10d7b13db'),
    ('lstm', 4096, 256, 52): ('a9b1452a331a8022dcbd8f7eb2a2688fc83a3ce7d45958a7d66012589903dddc', '43854bd5c44a4a21d0eaf28c46766af4d4235507fd77dd935da3efb65262f134'),
    ('lstm', 4096, 256, 512): ('5a5b64682b0fc938ebb32b3d2eed75a3fd73994df744b1e839c47a6109612eba', '5e9bd04f06c0bb88339a23a5bbdb5afc50f83c3b9bead2b09c3452ea088811d0'),
    ('gru', 512, 32, 21): ('fa94388461fa3cc13a23057c418e3cabc90eff08b4f1fcf06fee9b5e8c6006f5', '1b6d93080e630b0b18772cddc351d8a297691e86f9b31015a5be2add2113baa1'),
    ('gru', 512, 64, 21): ('852e2ba007ef3068e40581ff81314fde040ff93b1d174a9c8e46efe2820a4ae8', '5e36f342ebcecb81cd437a79721b0609d1190131b13535564538aceaf6e8ff28'),
    ('gru', 512, 128, 21): ('def5381a32d98a93b311ab1d1314df00a5c9ca658991a627213c44636937afb2', 'f9ca726b8c97ad274a307f30685028deea2033cf4d53244661a421cf9fc0d6ee'),
    ('lstm', 512, 32, 21): ('dbdc882b169e2c7d0c4e5ffff676312bffde243411c18830decc426c59d52a0b', '6967753447b19b75abd1ef5b8445e4942aeaa787cf26d2ac474a52c9a03fcd1a'),
    ('lstm', 512, 64, 21): ('990a0d151e16887c382b82e67bd1dc6c069849fdb103274d69908ae8073164af', '469043769587fbfdf9a0bca94733f50931f98f4577972ae05577c9d04dc850c1'),
    ('lstm', 512, 128, 21): ('75fc827761979b3686f9e920e37d4d2026d4a6bf476093bba2d44575106f6312', 'b933f927d6aaa2e15ebc988e475995e265bbde6a9ba4851a021bfc6cd08abb15'),
}


@pytest.mark.cuda
@pytest.mark.parametrize("case", CASES)
def test_fp32_backward_bit_equal_to_the_simt_gemm(case):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    assert bigru_vjp.k45_plan(case[2], torch.float32, case[0])["design"] == "simt"
    assert train_digests(*case) == PRODUCT_DIGESTS[case]
