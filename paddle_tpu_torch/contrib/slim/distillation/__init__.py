"""Knowledge distillation (counterpart of
paddle_tpu/contrib/slim/distillation/): `merge` grafts the teacher
program into the student program under a name prefix, and the loss
builders (l2_loss, soft_label_loss, fsp_loss over the fsp op) connect
teacher and student vars by name.
"""
from __future__ import annotations

from typing import Dict

__all__ = ["merge", "l2_loss", "soft_label_loss", "fsp_loss"]


def merge(teacher_program, student_program, data_name_map: Dict[str, str],
          scope=None, name_prefix: str = "teacher_"):
    """Copy the teacher's ops/vars into the student program, renaming
    every teacher var `name_prefix + name` except feeds, which map to
    student vars via data_name_map {teacher_feed: student_feed}.
    Teacher parameters are re-registered (persistable) so the scope's
    trained teacher weights drive the merged branch; they are marked
    stop_gradient so distillation trains only the student. Each copied
    op takes a new op uid: the engine keys a forward op's record for its
    grad op by uid, and a teacher and a student built after
    unique_name.reset() number their ops alike."""
    from ....core.registry import OP_UID_ATTR
    from ....framework import Operator, Parameter
    from ....executor import global_scope

    scope = scope or global_scope()
    t_block = teacher_program.global_block()
    s_block = student_program.global_block()

    def _new_name(n):
        if n in data_name_map:
            return data_name_map[n]
        return name_prefix + n

    for name, var in t_block.vars.items():
        if name in data_name_map:
            continue
        nn = _new_name(name)
        if s_block._find_var_recursive(nn) is not None:
            continue
        if isinstance(var, Parameter):
            p = Parameter(s_block, shape=var.shape, dtype=var.dtype,
                          name=nn, persistable=True, trainable=False)
            s_block.vars[nn] = p
            # move trained teacher weights under the new name
            v = scope.find_var(name)
            if v is not None and v.is_initialized():
                scope.var(nn).get_tensor().set_tensor(
                    v.get_tensor().tensor.clone())
        else:
            nv = s_block.create_var(
                name=nn, shape=list(var.shape), dtype=var.dtype,
                persistable=var.persistable)
            nv.stop_gradient = True
    for op in t_block.ops:
        if op.type in ("feed", "fetch"):
            continue
        inputs = {s: [_new_name(n) for n in op.input(s)]
                  for s in op.input_slots()}
        outputs = {s: [_new_name(n) for n in op.output(s)]
                   for s in op.output_slots()}
        attrs = {k: v for k, v in op._all_attrs() if k != OP_UID_ATTR}
        attrs["is_test"] = True
        new_op = Operator(s_block, op.type, inputs, outputs, attrs)
        s_block.ops.append(new_op)
    student_program._bump_version()
    return student_program


def _var(program, name):
    v = program.global_block()._find_var_recursive(name)
    assert v is not None, f"var {name!r} not in merged program"
    return v


def l2_loss(teacher_var_name, student_var_name, program):
    """The L2 distiller's loss: the mean squared error between two
    feature maps."""
    from .... import layers as L
    t = _var(program, teacher_var_name)
    s = _var(program, student_var_name)
    from ....framework import program_guard
    with program_guard(program):
        return L.reduce_mean(L.square(L.elementwise_sub(s, t)))


def soft_label_loss(teacher_var_name, student_var_name, program,
                    teacher_temperature=2.0, student_temperature=2.0):
    """The soft-label distiller's loss: the cross entropy of the
    student's softmax against the teacher's temperature-softened
    distribution."""
    from .... import layers as L
    from ....framework import program_guard
    t = _var(program, teacher_var_name)
    s = _var(program, student_var_name)
    with program_guard(program):
        t_soft = L.softmax(L.scale(t, scale=1.0 / teacher_temperature))
        t_soft.stop_gradient = True
        s_scaled = L.scale(s, scale=1.0 / student_temperature)
        ce = L.softmax_with_cross_entropy(s_scaled, t_soft,
                                          soft_label=True)
        return L.reduce_mean(ce)


def fsp_loss(teacher_var1_name, teacher_var2_name, student_var1_name,
             student_var2_name, program):
    """The FSP distiller's loss: the L2 distance between the teacher's
    and the student's FSP matrices of two feature maps (the fsp op)."""
    from .... import layers as L
    from ....framework import program_guard
    t1, t2 = _var(program, teacher_var1_name), \
        _var(program, teacher_var2_name)
    s1, s2 = _var(program, student_var1_name), \
        _var(program, student_var2_name)
    with program_guard(program):
        tf = L.fsp_matrix(t1, t2)
        tf.stop_gradient = True
        sf = L.fsp_matrix(s1, s2)
        return L.reduce_mean(L.square(L.elementwise_sub(sf, tf)))


from .strategies import (  # noqa: E402,F401
    DistillationStrategy, L2Distiller, SoftLabelDistiller,
    FSPDistiller)

__all__ += ["DistillationStrategy", "L2Distiller", "SoftLabelDistiller",
            "FSPDistiller"]
