"""The JAX package's training reference, compiled.

The JAX package's ``train_split``, its ``protocol_step`` and its workers
run the seeded init, the token-LM towers, the server and AdamW eagerly,
op by op: every primitive compiles once per leaf shape (AdamW alone
compiles some 400 of them), and an eager ``lax.scan`` (the layer stacks,
the SSD scan) is traced and compiled again at every call, so a few
reduced training steps take a minute of compilation.
:func:`compiled_reference` runs the same functions under ``jax.jit``,
which changes no value beyond f32 rounding, far below the tolerances the
tests hold.
"""
import contextlib
import functools

import jax
import jax.numpy as jnp
import pytest

from repro.models import backbone
from repro.models import split_program
from repro.optim.adamw import AdamW


@contextlib.contextmanager
def compiled_reference():
    """Within the block, ``repro.models.backbone.init_params``,
    ``AdamW.update`` and every program's ``tower_fwd`` and ``server_fwd``
    run under ``jax.jit``, one compiled function per config (the
    token-LM towers share one function, whatever the client; the audio
    and vlm towers, which differ by client, one per client; every worker
    builds its own program of the same config)."""
    init = jax.jit(backbone.init_params, static_argnums=(0, 2))
    update = jax.jit(AdamW.update, static_argnums=0)
    towers, servers = {}, {}
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(backbone, "init_params",
                   lambda cfg, key, dtype=jnp.float32: init(cfg, key, dtype))
        mp.setattr(AdamW, "update", lambda self, params, grads, state:
                   update(self, params, grads, state))
        for cls in (split_program.TokenLMSplitProgram,
                    split_program.AudioSplitProgram,
                    split_program.VLMSplitProgram):
            mp.setattr(cls, "tower_fwd", _compiled_tower(cls, towers))
            mp.setattr(cls, "server_fwd", _compiled_server(cls, servers))
        yield


def _compiled_tower(cls, cache: dict):
    tower_fwd = cls.tower_fwd
    shared = cls is split_program.TokenLMSplitProgram

    def tower(self, client):
        key = (cls, self.cfg, None if shared else client)
        if key not in cache:
            cache[key] = jax.jit(tower_fwd(self, client))
        return cache[key]

    return tower


def _compiled_server(cls, cache: dict):
    server_fwd = cls.server_fwd

    def server(self, sp, merged, *batch):
        key = (cls, self.cfg)
        if key not in cache:
            cache[key] = jax.jit(functools.partial(server_fwd, self))
        return cache[key](sp, merged, *batch)

    return server
