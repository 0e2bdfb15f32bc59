"""Runtime audits of the pipelined training step (reference:
``repro/analysis``).  The port keeps the reference's guarantees, not its
jaxpr walker: :mod:`.rules` is the registry of checks, :mod:`.audit` the
instruments that record one eager step and the schedule matrix, and
``python -m repro_torch.analysis`` the command that runs the matrix and
fails on any error finding.

Reference rules with no torch counterpart:
* ``comm.ppermute-permutation``: ``LocalRing.shift`` is a permutation by
  construction (``sent[(k - step) % K]``);
* ``comm.branch-uniform``, ``scale.carry-stability``, ``scale.eqn-budget``:
  there is no traced ``cond``, ``scan`` or equation count, the tick loop
  is Python;
* ``donation.aliased``: no donation in torch; its hazard is the
  supervisor's rescue references (``launch/train.py``), held only when a
  retry can need them;
* ``vmem.budget``: a TPU rule; its Hopper counterpart (registers, spills,
  shared memory per block) is ``chip_smoke.py`` phase 1's ptxas report.

The meta-device dryrun (``launch/dryrun.py``) waits for the port's meshes
(ROADMAP Queue 1 item 10).
"""
from .findings import Finding, errors

__all__ = ["Finding", "errors"]
