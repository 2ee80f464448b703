"""starcoder2-3b in the port against the JAX package, on the CPU.

The untied dense config at head dim 128 (24 q heads over 2 kv heads; its
towers 6 over 1): ``reduced()`` resets the head dim to d_model / heads, so
both packages' reduced configs get ``head_dim=128`` back by
``dataclasses.replace``, and every attention of the model, server and
towers alike, runs at the kernel's new head dim.  The JAX package's params
are carried across by ``interop``; one prompt past the 2048-token
threshold is served split on the CPU (the chunked plain attention, which
the card replaces by the flash kernel), against the JAX ``SplitLMServer``:
identical greedy tokens, the cut and the prefill logits within 1e-4 (the
long-prompt tolerance of ``tests/test_torch_flash.py``), equal ledger
bytes.
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.configs.base import get_arch as jax_get_arch
from repro.models import backbone as jax_backbone
from repro.models import split_program as jax_split_program
from repro.serve import SplitLMServer as JaxSplitLMServer
from repro.transport import SimTransport as JaxSimTransport
from repro.transport import TowerWorker as JaxTowerWorker
from repro_torch.configs.base import get_arch
from repro_torch.core import costs
from repro_torch.interop import params_from_numpy, to_numpy
from repro_torch.models import attention as attn
from repro_torch.models import split_program
from repro_torch.models import transformer as tfm
from repro_torch.serve import SplitLMServer
from repro_torch.transport import SimTransport, build_split_worker

ARCH = "starcoder2-3b"
HEAD_DIM = 128
PROMPT, NEW = 2304, 4
CACHE = PROMPT + NEW
LOGIT_TOL = dict(rtol=1e-4, atol=1e-4)


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """The suite runs in parallel worker processes: one intra-op thread
    keeps torch from oversubscribing the cores the other workers use."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _reduced(cfg):
    return dataclasses.replace(cfg.reduced(), head_dim=HEAD_DIM)


@pytest.fixture(scope="module")
def setup():
    jcfg, cfg = _reduced(jax_get_arch(ARCH)), _reduced(get_arch(ARCH))
    jparams = jax.jit(jax_backbone.init_params, static_argnums=0)(
        jcfg, jax.random.PRNGKey(0))
    params = params_from_numpy(jax.tree_util.tree_map(np.asarray, jparams),
                               "cpu")
    prompt = np.random.default_rng(17).integers(
        0, cfg.vocab_size, PROMPT).astype(np.int32)
    return jcfg, cfg, jparams, params, prompt


def test_full_width_dims():
    """The full config's attention is at head dim 128 on both sides of the
    cut (server 24 q / 2 kv heads, towers 6 / 1 of width 768), with
    untied embeddings; ``test_config_matches_jax`` holds the fields and
    the tower dims to the JAX package's."""
    cfg = get_arch(ARCH)
    dims = tfm.BlockDims.from_arch(cfg)
    tower = dims.scaled(cfg.vertical.num_clients)
    assert (dims.n_heads, dims.n_kv_heads, dims.head_dim) == (24, 2, 128)
    assert (tower.n_heads, tower.n_kv_heads, tower.head_dim,
            tower.d_model) == (6, 1, 128, 768)
    assert not cfg.tie_embeddings and cfg.rope_theta == 999999.0


def test_reduced_tree_matches_jax(setup):
    """The reduced tree at head dim 128 has the JAX package's keys and
    shapes, with a separate unembedding."""
    _, _, jparams, params, _ = setup
    jshapes = jax.tree_util.tree_map(lambda a: tuple(a.shape), jparams)

    def shapes(tree):
        if isinstance(tree, dict):
            return {k: shapes(v) for k, v in tree.items()}
        return tuple(tree.shape)

    assert shapes(params) == jshapes
    assert params["server"]["attn"]["wq"].shape[-1] == 4 * HEAD_DIM
    assert "unembed" in params["embed"]


def test_long_prompt_split_serving_matches_jax(setup):
    jcfg, cfg, jparams, params, prompt = setup
    assert PROMPT * PROMPT > attn.FLASH_THRESHOLD ** 2
    program = jax_split_program.get_program(jcfg)
    towers, jserver = program.partition(jparams)
    jworkers = [JaxTowerWorker(k, program.tower_fwd(k), towers[k],
                               serve_fns=program.tower_serve_fns(k))
                for k in range(jcfg.vertical.num_clients)]
    jsrv = JaxSplitLMServer(JaxSimTransport(jworkers), jcfg, jserver,
                            cache_len=CACHE)
    _, server = split_program.get_program(cfg).partition(params)
    workers = [build_split_worker(k, cfg=cfg, params=params, device="cpu")
               for k in range(cfg.vertical.num_clients)]
    srv = SplitLMServer(SimTransport(workers), cfg, server, cache_len=CACHE,
                        device="cpu")

    jcut = jsrv.driver.prefill(0, prompt, CACHE)
    jlogits, _ = jsrv._server_prefill(jsrv.server_params, jsrv._fresh_slot,
                                      jcut)
    cut = srv.driver.prefill(0, torch.from_numpy(prompt).long(), CACHE)
    logits, _ = srv._fns.prefill(srv.server_params,
                                 srv._fns.init_cache(CACHE), cut)
    np.testing.assert_allclose(to_numpy(cut), np.asarray(jcut), **LOGIT_TOL)
    np.testing.assert_allclose(to_numpy(logits), np.asarray(jlogits),
                               **LOGIT_TOL)

    jsrv.submit(prompt, max_new_tokens=NEW)
    srv.submit(prompt, max_new_tokens=NEW)
    jtokens = [r.tokens for r in jsrv.run()]
    tokens = [r.tokens for r in srv.run()]
    assert tokens == jtokens and len(tokens[0]) == NEW
    by_tag = {}
    for led, out in ((srv.ledger, "port"), (jsrv.ledger, "jax")):
        tags = {}
        for m in led.messages:
            tags[m.tag] = tags.get(m.tag, 0) + m.num_bytes
        by_tag[out] = tags
    assert by_tag["port"] == by_tag["jax"]
    K = cfg.vertical.num_clients
    pf = costs.serve_prefill_bytes(PROMPT, cfg.d_model, K)
    dc = costs.serve_decode_bytes(cfg.d_model, K, rounds=NEW - 1)
    # two prefill rounds in each ledger: the logits check, then the run
    assert srv.wire_report()["total"] == 2 * pf["total"] + dc["total"]
