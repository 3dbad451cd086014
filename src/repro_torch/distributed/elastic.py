"""Elastic scaling: restore a checkpoint onto a different mesh.

Checkpoints are mesh-agnostic (``{path: full array}``; a DTensor is saved
as its full tensor); re-scaling a job is ``restore -> param_pspecs(new_mesh)
-> distribute_tensor``, no format conversion.  The optimizer's moments
follow the params; its step count is replicated.
"""
from __future__ import annotations

from . import sharding as sh


def reshard_to_mesh(tree, mesh):
    """Place a tree of full tensors onto ``mesh`` (a ``DeviceMesh``) with
    the standard param rules; every rank passes the same tree."""
    return sh.distribute(tree, sh.param_pspecs(tree, mesh), mesh)


def rescale(ckpt_manager, step, params_template, opt_template, new_mesh):
    """Full elastic restart: checkpoint from any world size -> new mesh.
    Returns ``(params, opt_state, meta)``, the params and moments DTensors
    on ``new_mesh``."""
    params, opt, meta = ckpt_manager.restore(step, params_template, opt_template)
    params = reshard_to_mesh(params, new_mesh)
    if opt is not None:
        opt = type(opt)(step=opt.step,
                        mu=reshard_to_mesh(opt.mu, new_mesh),
                        nu=reshard_to_mesh(opt.nu, new_mesh))
    return params, opt, meta
