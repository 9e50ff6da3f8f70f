"""Opcode registry for tensor-program kernel graphs.

This is the shared vocabulary between (a) the synthetic program generator,
(b) the jaxpr importer, (c) the feature extractor, (d) the analytical model,
and (e) the ground-truth simulator. Each opcode carries the static semantics
the cost layers need: which functional unit it exercises, FLOPs per output
element, whether it hits the transcendental unit, and fusibility class.

The categories mirror XLA HLO opcodes (the paper's node vocabulary).
"""
from __future__ import annotations

from dataclasses import dataclass


@dataclass(frozen=True)
class OpInfo:
    name: str
    index: int
    unit: str            # 'mxu' | 'vpu' | 'mem' | 'special' | 'none'
    flops_per_elem: float  # FLOPs per output element (contractions override)
    transcendental: bool = False
    elementwise: bool = False
    fusible: bool = True   # can be fused into a producer/consumer group
    fusion_root_only: bool = False  # contraction: may only root a fusion
    arity: int = 1


_OPS: list[OpInfo] = []


def _op(name: str, unit: str, flops: float, *, trans=False, ew=False,
        fusible=True, root_only=False, arity=1) -> OpInfo:
    info = OpInfo(name, len(_OPS), unit, flops, transcendental=trans,
                  elementwise=ew, fusible=fusible, fusion_root_only=root_only,
                  arity=arity)
    _OPS.append(info)
    return info


# --- graph boundary ---------------------------------------------------------
PARAMETER = _op("parameter", "none", 0.0, arity=0)
CONSTANT = _op("constant", "none", 0.0, arity=0)
IOTA = _op("iota", "vpu", 0.0, arity=0)
RNG = _op("rng", "special", 4.0, trans=True, arity=0)

# --- elementwise unary ------------------------------------------------------
NEG = _op("negate", "vpu", 1.0, ew=True)
ABS = _op("abs", "vpu", 1.0, ew=True)
EXP = _op("exponential", "special", 4.0, trans=True, ew=True)
LOG = _op("log", "special", 4.0, trans=True, ew=True)
TANH = _op("tanh", "special", 6.0, trans=True, ew=True)
RSQRT = _op("rsqrt", "special", 2.0, trans=True, ew=True)
SQRT = _op("sqrt", "special", 2.0, trans=True, ew=True)
ERF = _op("erf", "special", 8.0, trans=True, ew=True)
LOGISTIC = _op("logistic", "special", 5.0, trans=True, ew=True)
SIGN = _op("sign", "vpu", 1.0, ew=True)
FLOOR = _op("floor", "vpu", 1.0, ew=True)
CONVERT = _op("convert", "vpu", 1.0, ew=True)
NOT = _op("not", "vpu", 1.0, ew=True)
SIN = _op("sine", "special", 6.0, trans=True, ew=True)
COS = _op("cosine", "special", 6.0, trans=True, ew=True)

# --- elementwise binary / ternary -------------------------------------------
ADD = _op("add", "vpu", 1.0, ew=True, arity=2)
SUB = _op("subtract", "vpu", 1.0, ew=True, arity=2)
MUL = _op("multiply", "vpu", 1.0, ew=True, arity=2)
DIV = _op("divide", "vpu", 3.0, ew=True, arity=2)
POW = _op("power", "special", 8.0, trans=True, ew=True, arity=2)
MAX = _op("maximum", "vpu", 1.0, ew=True, arity=2)
MIN = _op("minimum", "vpu", 1.0, ew=True, arity=2)
REM = _op("remainder", "vpu", 4.0, ew=True, arity=2)
AND = _op("and", "vpu", 1.0, ew=True, arity=2)
OR = _op("or", "vpu", 1.0, ew=True, arity=2)
COMPARE = _op("compare", "vpu", 1.0, ew=True, arity=2)
SELECT = _op("select", "vpu", 1.0, ew=True, arity=3)
CLAMP = _op("clamp", "vpu", 2.0, ew=True, arity=3)

# --- data movement / layout --------------------------------------------------
BROADCAST = _op("broadcast", "mem", 0.0)
RESHAPE = _op("reshape", "mem", 0.0)
TRANSPOSE = _op("transpose", "mem", 0.0)
CONCATENATE = _op("concatenate", "mem", 0.0, arity=2)
SLICE = _op("slice", "mem", 0.0)
PAD = _op("pad", "mem", 0.0)
REVERSE = _op("reverse", "mem", 0.0)
COPY = _op("copy", "mem", 0.0)
DYNAMIC_SLICE = _op("dynamic-slice", "mem", 0.0, arity=2)
DYNAMIC_UPDATE_SLICE = _op("dynamic-update-slice", "mem", 0.0, arity=3)
GATHER = _op("gather", "mem", 0.0, arity=2)
SCATTER = _op("scatter", "mem", 1.0, arity=3)

# --- reductions --------------------------------------------------------------
REDUCE_SUM = _op("reduce-sum", "vpu", 1.0)
REDUCE_MAX = _op("reduce-max", "vpu", 1.0)
REDUCE_MIN = _op("reduce-min", "vpu", 1.0)
REDUCE_PROD = _op("reduce-prod", "vpu", 1.0)
REDUCE_AND = _op("reduce-and", "vpu", 1.0)
REDUCE_OR = _op("reduce-or", "vpu", 1.0)
CUMSUM = _op("cumsum", "vpu", 1.0)
ARGMAX = _op("argmax", "vpu", 2.0)
SORT = _op("sort", "vpu", 8.0, fusible=False)
TOPK = _op("top-k", "vpu", 6.0, fusible=False)

# --- contractions (MXU) -------------------------------------------------------
DOT = _op("dot", "mxu", 2.0, root_only=True, arity=2)   # flops set from K dim
CONV = _op("convolution", "mxu", 2.0, root_only=True, arity=2)

# --- collectives / misc (appear when importing sharded jaxprs) ----------------
ALL_REDUCE = _op("all-reduce", "mem", 1.0, fusible=False)
ALL_GATHER = _op("all-gather", "mem", 0.0, fusible=False)
REDUCE_SCATTER = _op("reduce-scatter", "mem", 1.0, fusible=False)
ALL_TO_ALL = _op("all-to-all", "mem", 0.0, fusible=False)
COLLECTIVE_PERMUTE = _op("collective-permute", "mem", 0.0, fusible=False)
CUSTOM_CALL = _op("custom-call", "vpu", 2.0, fusible=False)
WHILE = _op("while", "none", 0.0, fusible=False)
SCAN = _op("scan", "none", 0.0, fusible=False)

OPCODES: tuple[OpInfo, ...] = tuple(_OPS)
NUM_OPCODES: int = len(OPCODES)
OP_BY_NAME: dict[str, OpInfo] = {o.name: o for o in OPCODES}
OP_BY_INDEX: dict[int, OpInfo] = {o.index: o for o in OPCODES}

ELEMENTWISE_UNARY = tuple(o for o in OPCODES if o.elementwise and o.arity == 1)
ELEMENTWISE_BINARY = tuple(o for o in OPCODES if o.elementwise and o.arity == 2)
TRANSCENDENTAL = tuple(o for o in OPCODES if o.transcendental)
REDUCTIONS = (REDUCE_SUM, REDUCE_MAX, REDUCE_MIN, REDUCE_PROD, CUMSUM)
CONTRACTIONS = (DOT, CONV)


# Map of jax primitive names -> OpInfo, used by the jaxpr importer.
JAX_PRIMITIVE_MAP: dict[str, OpInfo] = {
    "add": ADD, "add_any": ADD, "sub": SUB, "mul": MUL, "div": DIV,
    "max": MAX, "min": MIN, "pow": POW, "integer_pow": POW, "rem": REM,
    "and": AND, "or": OR, "xor": OR, "not": NOT,
    "neg": NEG, "abs": ABS, "exp": EXP, "exp2": EXP, "log": LOG,
    "log1p": LOG, "expm1": EXP, "tanh": TANH, "rsqrt": RSQRT, "sqrt": SQRT,
    "erf": ERF, "logistic": LOGISTIC, "sign": SIGN, "floor": FLOOR,
    "ceil": FLOOR, "round": FLOOR, "sin": SIN, "cos": COS,
    "convert_element_type": CONVERT, "bitcast_convert_type": CONVERT,
    "eq": COMPARE, "ne": COMPARE, "lt": COMPARE, "le": COMPARE,
    "gt": COMPARE, "ge": COMPARE, "select_n": SELECT, "clamp": CLAMP,
    "broadcast_in_dim": BROADCAST, "reshape": RESHAPE,
    "squeeze": RESHAPE, "expand_dims": RESHAPE, "transpose": TRANSPOSE,
    "concatenate": CONCATENATE, "slice": SLICE, "pad": PAD, "rev": REVERSE,
    "copy": COPY, "dynamic_slice": DYNAMIC_SLICE,
    "dynamic_update_slice": DYNAMIC_UPDATE_SLICE,
    "gather": GATHER, "scatter": SCATTER, "scatter_add": SCATTER,
    "scatter-add": SCATTER,
    "reduce_sum": REDUCE_SUM, "reduce_max": REDUCE_MAX,
    "reduce_min": REDUCE_MIN, "reduce_prod": REDUCE_PROD,
    "reduce_and": REDUCE_AND, "reduce_or": REDUCE_OR,
    "cumsum": CUMSUM, "cumlogsumexp": CUMSUM, "cummax": CUMSUM,
    "argmax": ARGMAX, "argmin": ARGMAX, "reduce_precision": CONVERT,
    "sort": SORT, "top_k": TOPK, "iota": IOTA,
    "dot_general": DOT, "conv_general_dilated": CONV,
    "psum": ALL_REDUCE, "all_gather": ALL_GATHER,
    "psum_scatter": REDUCE_SCATTER, "all_to_all": ALL_TO_ALL,
    "ppermute": COLLECTIVE_PERMUTE,
    "random_bits": RNG, "random_seed": RNG, "random_wrap": RNG,
    "random_fold_in": RNG, "threefry2x32": RNG,
    "stop_gradient": COPY, "while": WHILE, "scan": SCAN,
    "custom_jvp_call": CUSTOM_CALL, "custom_vjp_call": CUSTOM_CALL,
    "remat": CUSTOM_CALL, "checkpoint": CUSTOM_CALL,
    "erf_inv": ERF, "atan2": SIN, "asin": SIN, "acos": SIN, "atan": SIN,
    "sinh": SIN, "cosh": COS, "asinh": SIN, "acosh": COS, "atanh": TANH,
    "square": MUL, "is_finite": COMPARE, "nextafter": ADD,
    "real": COPY, "imag": COPY, "conj": COPY, "complex": ADD,
    "cbrt": RSQRT, "population_count": ABS, "clz": ABS,
    "shift_left": MUL, "shift_right_logical": DIV,
    "shift_right_arithmetic": DIV,
}
