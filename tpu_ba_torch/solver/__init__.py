"""LM loop, Schur complement, PCG and their host plans.

``solve`` is re-exported lazily: the kernel wrappers import modules of this
package, and ``solver.lm`` imports the kernel wrappers."""


def __getattr__(name):
    if name == "solve":
        from tpu_ba_torch.solver.lm import solve

        return solve
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
