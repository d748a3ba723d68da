"""Eager argument contracts at the ``ops.sweep`` / ``ops.infer`` boundary.

The port of ``repro.analysis.validate``: shape, dtype and plan checks that
read no tensor value and raise :class:`ContractError` before any launch.
``kernels.ops`` re-exports every name here, so ``ops.ContractError`` is
this class.  :class:`SanitizerError` is what ``analysis.sanitizer`` raises
when a numerical invariant of a result fails under ``debug_checks=True``.
"""
from __future__ import annotations

import torch

#: Serving φ storage dtypes ``ops.infer`` accepts (``InferPlan.phi_dtype``).
PHI_DTYPES = ("float32", "bfloat16", "int8")


class ContractError(ValueError):
    """An ``ops`` entry point's argument violates a launch contract."""


def require(ok: bool, msg: str) -> None:
    if not ok:
        raise ContractError(msg)


class SanitizerError(RuntimeError):
    """A numerical invariant of a sweep or inference result failed
    (``analysis.sanitizer``, under ``debug_checks=True``); the message is
    the JAX package's ``sanitizer: …`` message of the first that failed,
    and ``failed`` every failed invariant's message, in the same order."""

    def __init__(self, msg: str, failed=None):
        super().__init__(msg)
        self.failed = list(failed) if failed is not None else [msg]


def refuse_debug_checks(debug_checks: bool, where: str) -> None:
    """Raise ContractError for ``debug_checks=True`` at an entry point that
    never reaches ``ops.sweep`` or ``ops.infer``, where the sanitizer runs:
    in the JAX package the flag has no effect there, and a request for
    checks must not pass silently unchecked."""
    require(not debug_checks,
            f"{where}: debug_checks=True has no effect here: its sweeps "
            "never reach ops.sweep or ops.infer, where the numerical-"
            "invariant sanitizer runs (as in the JAX package, which "
            "ignores the flag there); run with debug_checks=False")


def _is_int(t: torch.Tensor) -> bool:
    return not (t.dtype.is_floating_point or t.dtype.is_complex
                or t.dtype == torch.bool)


def _check_plan(plan) -> None:
    """A sharded plan names its model axis by a ``launch.mesh.MeshAxis``;
    a sweep plan's ``two_phase`` is a bool."""
    axis = getattr(plan, "axis_name", None)
    require(
        axis is None or hasattr(axis, "all_reduce"),
        f"a topic-sharded plan takes the model axis of a launch.mesh.Mesh "
        f"(mesh.model), which carries its process group, not "
        f"{type(axis).__name__} {axis!r}",
    )
    two_phase = getattr(plan, "two_phase", True)
    require(isinstance(two_phase, bool),
            f"SweepPlan.two_phase must be a bool, got {two_phase!r}")


def _check_hooks(plan, word_topics, norm_psum, renorm_psum) -> None:
    """Raw reduction hooks: not with a sharded plan (the JAX refusal), each
    a callable, and the one of the sweep's form — ``norm_psum`` the dense
    E-step normaliser, ``renorm_psum`` the scheduled eq. 38 sums."""
    if norm_psum is None and renorm_psum is None:
        return
    require(
        getattr(plan, "axis_name", None) is None,
        "pass EITHER a sharded SweepPlan OR raw norm_psum/renorm_psum "
        "hooks, not both",
    )
    for name, hook in (("norm_psum", norm_psum),
                       ("renorm_psum", renorm_psum)):
        require(hook is None or callable(hook),
                f"{name} must be a callable (D, 1) -> (D, 1), got "
                f"{type(hook).__name__}")
    scheduled = word_topics is not None
    require(
        norm_psum is None or not scheduled,
        "norm_psum hooks the dense sweep's E-step normaliser; a scheduled "
        "sweep (word_topics given) takes renorm_psum",
    )
    require(
        renorm_psum is None or scheduled,
        "renorm_psum hooks the scheduled sweep's eq. 38 sums; a dense sweep "
        "(no word_topics) takes norm_psum",
    )


def _check_word_topics(word_topics, num_rows: int, num_topics: int) -> None:
    if word_topics is None:
        return
    require(
        word_topics.ndim == 2,
        f"word_topics must be (W_s, A) per-word active topic sets, got "
        f"shape {tuple(word_topics.shape)}",
    )
    require(
        _is_int(word_topics),
        f"word_topics must be an integer array, got dtype "
        f"{word_topics.dtype}",
    )
    require(
        word_topics.shape[0] == num_rows,
        f"word_topics rows ({word_topics.shape[0]}) must match the phi "
        f"working-set rows W_s ({num_rows})",
    )
    require(
        word_topics.shape[1] <= num_topics,
        f"word_topics active set A ({word_topics.shape[1]}) cannot exceed "
        f"K ({num_topics})",
    )


def validate_infer_args(
    word_ids, est_counts, theta0, phi_norm,
    *,
    ev_counts=None,
    word_topics=None,
    plan=None,                      # core.types.InferPlan
    phi_dtype: str = "float32",
) -> None:
    """Check every ``ops.infer`` argument contract; raise ContractError.

    Shape/dtype-only: no tensor value is read.  ``phi_norm`` arrives as the
    caller's float32 array; quantization happens after validation.
    """
    require(
        phi_dtype in PHI_DTYPES,
        f"phi_dtype must be one of {PHI_DTYPES}, got {phi_dtype!r}",
    )
    _check_plan(plan)
    require(
        plan is None or plan.axis_name is None or phi_dtype == "float32",
        f"a topic-sharded InferPlan takes float32 phi, not {phi_dtype}: its "
        "fit is plain PyTorch and quantization is a kernel storage format",
    )
    require(
        word_ids.ndim == 2 and _is_int(word_ids),
        f"word_ids must be a (D, L) integer array, got shape "
        f"{tuple(word_ids.shape)} dtype {word_ids.dtype}",
    )
    D, L = word_ids.shape
    require(
        tuple(est_counts.shape) == (D, L)
        and est_counts.dtype.is_floating_point,
        f"est_counts must be a float (D, L) = ({D}, {L}) array matching "
        f"word_ids, got shape {tuple(est_counts.shape)} dtype "
        f"{est_counts.dtype}",
    )
    if ev_counts is not None:
        require(
            tuple(ev_counts.shape) == (D, L),
            f"ev_counts must share word_ids' (D, L) = ({D}, {L}) layout "
            f"(split_heldout_counts preserves it), got "
            f"{tuple(ev_counts.shape)}",
        )
    require(
        theta0.ndim == 2 and theta0.shape[0] == D,
        f"theta0 must be (D, K) with D = {D}, got {tuple(theta0.shape)}",
    )
    K = theta0.shape[-1]
    require(
        phi_norm.ndim == 2 and phi_norm.shape[1] == K,
        f"phi_norm must be (W_s, K) with K = {K}, got "
        f"{tuple(phi_norm.shape)}",
    )
    require(
        theta0.dtype == phi_norm.dtype == torch.float32,
        f"theta0 ({theta0.dtype}) and phi_norm ({phi_norm.dtype}) must both "
        "be float32: the fixed point computes in float32",
    )
    _check_word_topics(word_topics, phi_norm.shape[0], K)


def validate_sweep_args(
    word_ids, counts, mu, theta, phi_wk, phi_k,
    *,
    word_topics=None,
    token_active=None,
    plan=None,                      # core.types.SweepPlan
    norm_psum=None,
    renorm_psum=None,
) -> None:
    """Check every ``ops.sweep`` argument contract; raise ContractError.

    Shape/dtype-only: no tensor value is read.
    """
    _check_plan(plan)
    _check_hooks(plan, word_topics, norm_psum, renorm_psum)
    require(
        word_ids.ndim == 2 and _is_int(word_ids),
        f"word_ids must be a (D, L) integer array, got shape "
        f"{tuple(word_ids.shape)} dtype {word_ids.dtype}",
    )
    D, L = word_ids.shape
    require(
        tuple(counts.shape) == (D, L) and counts.dtype.is_floating_point,
        f"counts must be a float (D, L) = ({D}, {L}) array matching "
        f"word_ids, got shape {tuple(counts.shape)} dtype {counts.dtype}",
    )
    require(
        mu.ndim == 3 and tuple(mu.shape[:2]) == (D, L),
        f"mu must be (D, L, K) = ({D}, {L}, K) responsibilities, got "
        f"shape {tuple(mu.shape)}",
    )
    K = mu.shape[-1]
    require(
        tuple(theta.shape) == (D, K),
        f"theta must be (D, K) = ({D}, {K}), got {tuple(theta.shape)}",
    )
    require(
        phi_wk.ndim == 2 and phi_wk.shape[1] == K,
        f"phi_wk must be (W_s, K) with K = {K}, got "
        f"{tuple(phi_wk.shape)}",
    )
    require(
        tuple(phi_k.shape) == (K,),
        f"phi_k must be (K,) = ({K},), got {tuple(phi_k.shape)}",
    )
    dtypes = {"mu": mu.dtype, "theta": theta.dtype,
              "phi_wk": phi_wk.dtype, "phi_k": phi_k.dtype}
    require(
        set(dtypes.values()) == {torch.float32},
        "mu/theta/phi_wk/phi_k must all be float32 (the sweep computes in "
        "float32), got " + ", ".join(f"{k}={v}" for k, v in dtypes.items()),
    )
    _check_word_topics(word_topics, phi_wk.shape[0], K)
    if token_active is not None:
        require(
            tuple(token_active.shape) == (D, L),
            f"token_active must be a (D, L) = ({D}, {L}) mask, got "
            f"{tuple(token_active.shape)}",
        )
