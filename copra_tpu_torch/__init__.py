"""copra-tpu ported to PyTorch and CUDA (NVIDIA Hopper).

The second implementation of the linear-MPC engine in ``copra_tpu``, which
stays the reference.  Ported so far: condensing, cost and constraint
lowering, QP assembly, the general ADMM solver (``solve_qp``) with its
registry, ``solve_mpc``, the ``LMPC`` facade and the scenario batch
(``solve_mpc_batch``), control plans with every serving step of
``make_plan_step`` (the accurate and f32 fused ticks on per-lane and shared
plans, the box-only and general-row steps) and its multistep chain
(``make_plan_multistep``), the stagewise Riccati-in-ADMM engine with its
serving tick, multistep chain (``make_stagewise_multistep``), measured
serving policies (``auto_rho_stagewise``, ``auto_iters_stagewise``), f64
polish and no-knobs server (``make_stagewise_server``), the no-knobs
one-shot ``solve``, the log-depth forms (``lqr_solve_assoc``,
``condense_lti_assoc``, ``condense_ltv_assoc``), and the modules a
controller is wrapped in: :mod:`.receding` (the closed loop),
:mod:`.checkpoint` (save and resume) and :mod:`.profiling` (spans, timing,
metrics and device time from a trace); and :mod:`.parallel`, the
scenario batch and, on ``torch.distributed``, the meshes, the sharded
serving step and the model- and horizon-parallel solves.  On a CUDA device the multistep chains run as
CUDA graphs, their ticks free of host syncs.  The fixed-count ADMM
iterations and the batched Cholesky run in hand-written CUDA kernels
(``csrc/admm_box.cu``, ``csrc/admm_box_shared.cu``,
``csrc/admm_general_shared.cu``, ``csrc/admm_general.cu``,
``csrc/chol_batched.cu``, ``csrc/stagewise_tick.cu``); on the CPU each
kernel's plain PyTorch version runs instead.  Names match the
reference's.  What the entry points build from numpy arrays and Python
numbers goes to the package's default device, the GPU unless
:func:`set_default_device` says otherwise.  Importing this package imports
neither JAX nor ``copra_tpu``.
"""

from ._tensors import default_device, set_default_device
from .autospan import span_matrix, span_vector
from .constraints import (Constraint, ConstraintKind, ControlBoundConstraint,
                          ControlConstraint, MixedConstraint,
                          TrajectoryBoundConstraint, TrajectoryConstraint)
from .costs import (ControlCost, CostFunction, MixedCost, SimpleControlCost,
                    SimpleTrajectoryCost, TargetCost, TrajectoryCost)
from .errors import (CopraError, DimensionError, InfeasibleProblemError,
                     InitializationError, SolverError)
from .mpc import HESSIAN_RIDGE, LMPC, MPCResult, build_qp, solve_mpc
from .parallel.batch import solve_mpc_batch
from .plan import (ControlPlan, auto_rho, make_control_plan,
                   make_plan_multistep, make_plan_step, make_seed_map,
                   plan_qp, plan_trajectory, suggest_rho)
from .qp.admm import solve_qp, solve_qp_batched
from .qp.native import native_available, solve_qp_native
from .qp.registry import available_solvers, get_solver, register_solver
from .qp.riccati import (StagewiseQP, auto_iters_stagewise,
                         auto_rho_stagewise, lqr_solve, lqr_solve_assoc,
                         make_stagewise_multistep, make_stagewise_server,
                         make_stagewise_step, scale_stagewise,
                         solve_mpc_stagewise, solve_stagewise,
                         stack_stagewise, stagewise_scales)
from .solve import solve
from .qp.types import (STATUS_DUAL_INFEASIBLE, STATUS_MAX_ITER,
                       STATUS_PRIMAL_INFEASIBLE, STATUS_SOLVED, DenseQP,
                       QPSolution, SolverOptions, WarmStart)
from .systems import (LTISystem, LTVSystem, Preview, condense, condense_lti,
                      condense_lti_assoc, condense_ltv, condense_ltv_assoc,
                      lti_as_ltv, replay_dynamics)

__version__ = "0.1.0"

__all__ = [
    "set_default_device", "default_device",
    "LMPC", "MPCResult", "solve", "solve_mpc", "solve_mpc_batch",
    "build_qp", "HESSIAN_RIDGE",
    "solve_qp", "solve_qp_batched",
    "register_solver", "get_solver", "available_solvers",
    "ControlPlan", "make_control_plan", "make_plan_step",
    "make_plan_multistep", "make_seed_map",
    "plan_qp", "plan_trajectory", "auto_rho", "suggest_rho",
    "LTISystem", "LTVSystem", "Preview", "condense", "condense_lti",
    "condense_ltv", "condense_lti_assoc", "condense_ltv_assoc",
    "lti_as_ltv", "replay_dynamics",
    "CostFunction", "TrajectoryCost", "SimpleTrajectoryCost", "TargetCost",
    "ControlCost", "SimpleControlCost", "MixedCost",
    "Constraint", "ConstraintKind", "TrajectoryConstraint",
    "ControlConstraint", "MixedConstraint", "TrajectoryBoundConstraint",
    "ControlBoundConstraint",
    "DenseQP", "QPSolution", "SolverOptions", "WarmStart",
    "STATUS_SOLVED", "STATUS_MAX_ITER", "STATUS_PRIMAL_INFEASIBLE",
    "STATUS_DUAL_INFEASIBLE",
    "native_available", "solve_qp_native",
    "StagewiseQP", "lqr_solve", "lqr_solve_assoc", "solve_stagewise",
    "solve_mpc_stagewise", "make_stagewise_step",
    "make_stagewise_multistep", "make_stagewise_server",
    "auto_rho_stagewise", "auto_iters_stagewise", "stack_stagewise",
    "stagewise_scales", "scale_stagewise",
    "span_matrix", "span_vector",
    "CopraError", "DimensionError", "InitializationError", "SolverError",
    "InfeasibleProblemError",
]
