"""flax 0.12.3's derivation of a module's dropout keys, without flax.

``module.apply(..., rngs={"dropout": key})`` gives the root scope the key; a
submodule's scope is its parent's path plus its name; ``make_rng("dropout")``
in a scope counts the scope's draws and returns

    _fold_in_static(key, path + (count,))

(``flax/core/scope.py``: ``Scope.push`` / ``LazyRng`` / ``Scope.make_rng``):
``jax.random.fold_in`` of the first four bytes (big-endian) of the SHA-1 of
the path's names (UTF-8) and the count (its big-endian bytes), with no
separator between them (``flax_fix_rng_separator`` is off by default in
0.12.3). A scope keeps its count when it is entered again (a shared layer
called once a layer), as flax keeps it in the parent's ``rng_counters``.
``nn.Dropout`` draws in a scope of its own, auto-named ``Dropout_<k>`` in the
order of the parent's calls.

``KeyStream`` is the dropout stream of one forward (a train step's, a scored
batch's): its key (JAX's ``rngs["dropout"]``), a fresh root scope for each
``apply`` of the JAX package's it stands for (``scope()``), and the global
rows (``batch0`` of ``global_batch``) a data-parallel rank's forward is of.
A site draws in its module's scope: ``salt()`` on the hash routes (the salt
``jax.random.bits(make_rng(), (2,))``, the same pair ``bits(·, (1, 2))``
gives), ``key()`` on the flax routes. ``salts=`` replays a list of salts in
place of drawing them: the hash routes take them in the order the sites run,
and a flax site refuses the replay.
"""
from __future__ import annotations

import hashlib
from typing import Dict, Iterable, Optional, Tuple, Union

from . import prng

# flax.config.flax_fix_rng_separator's default in flax 0.12.3
FIX_RNG_SEPARATOR = False


def fold_in_static(key: prng.Key, data: Tuple[Union[str, int], ...]) -> prng.Key:
    """flax's ``_fold_in_static(key, data)``."""
    if not data:
        return key
    m = hashlib.sha1()
    for x in data:
        if FIX_RNG_SEPARATOR:
            m.update(b"\00")
        if isinstance(x, str):
            m.update(x.encode("utf-8"))
        elif isinstance(x, int):
            m.update(x.to_bytes((x.bit_length() + 7) // 8, byteorder="big"))
        else:
            raise ValueError(f"Expected int or string, got: {x}")
    return prng.fold_in(key, int.from_bytes(m.digest()[:4], byteorder="big"))


class Scope:
    """A flax scope's "dropout" stream: its path under the apply's root, its
    count of ``make_rng`` calls, and its children (kept, so that a scope
    entered again keeps counting)."""

    def __init__(self, stream: "KeyStream", path: Tuple[str, ...] = ()):
        self.stream, self.path = stream, path
        self.count = 0
        self._children: Dict[str, "Scope"] = {}

    def child(self, name: str) -> "Scope":
        if name not in self._children:
            self._children[name] = Scope(self.stream, self.path + (name,))
        return self._children[name]

    def make_rng(self) -> prng.Key:
        self.count += 1
        return fold_in_static(self.stream.key, self.path + (self.count,))

    def salt(self) -> Tuple[int, int]:
        """A hash route's salt: ``bits(make_rng(), (2,))``, or the next
        replayed one."""
        return self.stream.draw(lambda: prng.host_bits(self.make_rng(), 2))

    def key(self) -> prng.Key:
        """A flax route's key: ``make_rng()`` (a replay refuses it)."""
        if self.stream.replaying:
            raise ValueError(
                f"a replayed SaltStream holds the hash routes' salts, but the site at "
                f"{'/'.join(self.path) or '(root)'} draws a flax mask: set "
                "SE_HIDDEN_DROPOUT_IMPL=hash and SE_ATTN_IMPL=flash (or the explicit "
                "path's SE_DROPOUT_IMPL=hash) to replay")
        return self.stream.draw(self.make_rng)

    def dropout_key(self, index: int) -> prng.Key:
        """The key of the scope's ``index``-th ``nn.Dropout`` (auto-named
        ``Dropout_<index>``)."""
        return self.child(f"Dropout_{index}").key()

    @property
    def batch0(self) -> int:
        return self.stream.batch0


class KeyStream:
    """The dropout keys of one forward (the module docstring).

    ``key`` is JAX's ``rngs["dropout"]``; without it, ``fold_in(PRNGKey(seed),
    step)``: the key the JAX train step folds from a step key ``PRNGKey(seed)``
    at step ``step``. ``salts`` replays salts (pairs of uint32) in place of
    drawing them. ``batch0`` / ``global_batch`` place the forward's rows in
    the step's global batch (a data-parallel rank's: ``parallel/mesh.py``);
    every mask keys on the global row. ``drawn`` counts the sites that drew."""

    def __init__(self, seed: int = 0, step: int = 0,
                 salts: Optional[Iterable[Tuple[int, int]]] = None, batch0: int = 0,
                 global_batch: Optional[int] = None, key: Optional[prng.Key] = None):
        self.key = (prng.fold_in(prng.PRNGKey(seed), step) if key is None
                    else tuple(int(k) & prng.MASK32 for k in key))
        self._replay = None if salts is None else iter(
            [tuple(int(s) & prng.MASK32 for s in pair) for pair in salts])
        self.drawn = 0
        self.batch0 = int(batch0)
        self.global_batch = global_batch
        self._root = Scope(self)

    @property
    def replaying(self) -> bool:
        return self._replay is not None

    def scope(self) -> Scope:
        """A fresh root scope: one ``apply`` of a JAX module on this key."""
        return Scope(self)

    def draw(self, make):
        self.drawn += 1
        if self._replay is None:
            return make()
        try:
            return next(self._replay)
        except StopIteration:
            raise ValueError(f"the replayed salts ran out at site {self.drawn}") from None

    def __call__(self) -> Tuple[int, int]:
        """The next salt of a root-scope hash site."""
        return self._root.salt()


def as_scope(rng) -> Optional[Scope]:
    """A module's scope from what its forward was given: None, a ``Scope``
    (the module is a child), or a ``KeyStream`` (the module is the apply's
    root)."""
    if rng is None or isinstance(rng, Scope):
        return rng
    return rng.scope()
