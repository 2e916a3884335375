"""mav_tube_trajectory_generation: batched polynomial trajectory
optimization.

A from-scratch JAX/XLA re-design of the capabilities of
NilsFunk/mav_tube_trajectory_generation (C++/Eigen/Mosek/NLOPT): snap-minimizing
polynomial segment optimization, tube/corridor-constrained QCQP, collision-aware
nonlinear refinement, and batched feasibility checking -- engineered for
thousands of scenarios solved in parallel on accelerators rather than one solve
per process.

Quick start::

    import numpy as np
    import mav_tube_trajectory_generation as mtg

    vertices = mtg.create_random_vertices(4, n_segments=10,
                                          pos_min=np.zeros(3),
                                          pos_max=10 * np.ones(3), seed=0)
    structure, values = mtg.structure_from_vertices(vertices)
    times = mtg.estimate_segment_times(vertices, v_max=3.0, a_max=5.0)
    d_fixed = mtg.extract_fixed_values(structure, values)
    sol = mtg.solve_linear(structure, d_fixed, times)
    traj = mtg.Trajectory(sol.coefficients, sol.times)
"""

from . import motion_defines
from .motion_defines import (POSITION, VELOCITY, ACCELERATION, JERK, SNAP)

from .solver.structure import (ProblemStructure, make_structure,
                               standard_mask, free_interior_mask)
from .solver.linear import (LinearSolution, solve_linear,
                            solve_linear_with_free, extract_fixed_values,
                            assemble_r, derivative_cost_and_grad,
                            compact_from_segment_derivatives,
                            solve_from_positions)
from .solver.qcqp import (ADMMConfig, QCQPSolution, solve_qcqp,
                          solve_qcqp_batch, position_constrained_warmstart)
from .solver.banded import solve_linear_banded, block_tridiag_solve
from .solver.ipm import IPMConfig, solve_qcqp_ipm, solve_qcqp_polished
from .solver.ipm_lanes import (solve_qcqp_ipm_lanes,
                               solve_qcqp_polished_batch)
from .solver.auto import (AutoResult, FEASIBLE, INFEASIBLE, UNDETERMINED,
                          solve_qcqp_auto, solve_qcqp_strict,
                          solve_qcqp_strict_sharded)
from .solver.nonlinear import (Objective, CostWeights, MagnitudeConstraint,
                               NonlinearParameters, NonlinearResult,
                               optimize, optimize_time_gradient)
from .models.esdf import (Esdf, esdf_from_occupancy, distance_at,
                          collision_potential, make_obstacle_grid)
from .models.vertex import (Vertex, vertices_to_arrays, structure_from_vertices,
                            create_random_vertices, create_random_vertices_1d,
                            create_square_vertices,
                            estimate_segment_times,
                            estimate_segment_times_nfabian,
                            estimate_segment_times_velocity_ramp,
                            segment_times_nfabian, segment_times_velocity_ramp)
from .models.trajectory import (Trajectory, Extremum, evaluate, evaluate_range,
                                sample_times, min_max_magnitude, max_magnitude,
                                append_dimension, get_vertex_at_time,
                                scale_trajectory_time, scale_times_to_limits)

__version__ = "0.1.0"
