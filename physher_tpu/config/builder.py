"""JSON model-graph builder: interprets reference-format physher configs.

Rebuild of the reference's JSON factory layer (reference: src/physher.c:128-205
model construction, plus the per-type ``new_*_from_json`` factories). A config
is a dict of model objects (each with ``id`` and ``type``) plus a ``physher``
action list. Cross-references use the reference's syntax
(reference: src/phyc/parameters.h:384-392):

- ``&id``   — reference to a previously built object/parameter,
- ``%name`` — multi-parameter slice (e.g. ``%tree.distances``),
- ``$id``   — the parameters of a simplex.

Components map to physher_tpu model objects; JSON parameter ids map to
ParamSpec names recorded in ``Context.param_names`` so actions (optimizers,
operators, loggers) can address them.
"""

from __future__ import annotations

import copy
import math
import os

import numpy as np

from ..data.datatype import get_datatype, GeneralDataType
from ..data.sitepattern import SitePattern
from ..data.distance import distance_matrix
from ..io.seqio import read_alignment
from ..io.treeio import read_newick
from ..models.clock import StrictClock, DiscreteClock, RelaxedClock
from ..models.parameters import ParamSpec, ParamSpace
from ..models.sitemodel import (
    ConstantSiteModel, DiscreteSiteModel, InvariantSiteModel, QuantileSiteModel,
)
from ..models.substitution import (
    GTR, HKY, JC69, K80, F81, UNREST, NONSTAT, GeneralReversible,
    SubstitutionModel,
)
from ..models.treelikelihood import TreeLikelihood
from ..trees.build import nj, upgma
from ..trees.timetree import TimeTreeData
from ..trees.topology import Topology


class Context:
    """Build-time registry (the reference's Hashtable, src/physher.c:140)."""

    def __init__(self, base_dir: str = "."):
        self.base_dir = base_dir
        self.objects: dict[str, object] = {}
        # JSON parameter id -> (spec name, component) for action resolution
        self.param_names: dict[str, str] = {}
        # simplex id -> spec name
        self.simplex_names: dict[str, str] = {}
        # composite name -> list of spec names (e.g. reparam vector aliases)
        self.slices: dict[str, list] = {}
        self.extra_specs: list[ParamSpec] = []

    def resolve_target(self, ref) -> list:
        """Resolve '&id' / '%name' / '$id' to a list of spec names
        (reference: src/phyc/parameters.h:384-392)."""
        if isinstance(ref, list):
            out = []
            for r in ref:
                out.extend(self.resolve_target(r))
            return out
        if not isinstance(ref, str):
            raise ValueError(f"cannot resolve target {ref!r}")
        if ref.startswith("&") or ref.startswith("$"):
            name = ref[1:]
        elif ref.startswith("%"):
            name = ref[1:]
        else:
            name = ref
        if name in self.slices:
            return list(self.slices[name])
        if name in self.param_names:
            return [self.param_names[name]]
        return [name]

    def register(self, id_, obj):
        if id_:
            self.objects[id_] = obj

    def resolve(self, node):
        """Resolve '&id' string references."""
        if isinstance(node, str) and node.startswith("&"):
            return self.objects[node[1:]]
        return node

    def path(self, p):
        if os.path.isabs(p):
            return p
        return os.path.join(self.base_dir, p)


def loads_tolerant(text: str):
    """json.loads tolerating trailing commas before ``]``/``}``.

    The reference's hand-rolled parser accepts them (src/phyc/mjson.c:633
    skips a comma then a closing bracket without complaint) and its own
    fixtures rely on it (tests/data/f81.json), so strict parsing would
    reject configs the reference runs unmodified.
    """
    import json as _json
    import re as _re

    # strip string literals before locating trailing commas, then remove
    # those commas from the original text by offset
    out, i, drop = [], 0, []
    # blank string literals with a non-whitespace filler so in-string
    # commas/brackets can't match and blanks don't read as whitespace
    no_str = _re.sub(r'"(?:\\.|[^"\\])*"', lambda m: "0" * len(m.group()), text)
    for m in _re.finditer(r",(\s*[\]}])", no_str):
        drop.append(m.start())
    for d in drop:
        out.append(text[i:d])
        i = d + 1
    out.append(text[i:])
    return _json.loads("".join(out))


def load_json(path: str):
    """Read a reference-format JSON config file (mjson-compatible)."""
    with open(path) as fh:
        return loads_tolerant(fh.read())


def _prune(node):
    """Remove ignored/underscored entries (reference: src/physher.c:135-136)."""
    if isinstance(node, dict):
        return {
            k: _prune(v)
            for k, v in node.items()
            if not k.startswith("_")
            and not (isinstance(v, dict) and v.get("ignore") is True)
        }
    if isinstance(node, list):
        return [_prune(v) for v in node]
    return node


# -- parameters -------------------------------------------------------------


def _param_value(node, ctx: Context, default=None):
    """Extract a scalar/vector parameter's initial value from JSON."""
    node = ctx.resolve(node)
    if isinstance(node, ParamSpec):
        v = node.init
        return float(v) if np.ndim(v) == 0 else np.asarray(v)
    if isinstance(node, (int, float)):
        return float(node)
    if isinstance(node, list):
        return np.asarray(node, dtype=np.float64)
    if isinstance(node, dict):
        v = node.get("values", node.get("value", default))
        if isinstance(v, list):
            return np.asarray(v, dtype=np.float64)
        return float(v)
    raise ValueError(f"cannot read parameter value from {node!r}")


def _bound(node, key, default):
    v = node.get(key, default) if isinstance(node, dict) else default
    if v in ("infinity", "inf"):
        return np.inf
    if v in ("-infinity", "-inf"):
        return -np.inf
    return float(v)


def build_parameter_spec(node, ctx: Context, name=None, lower=-np.inf,
                         upper=np.inf):
    """Build a ParamSpec from a JSON parameter node and register its id."""
    node = ctx.resolve(node)
    if isinstance(node, dict):
        pid = node.get("id")
        lower = _bound(node, "lower", lower)
        upper = _bound(node, "upper", upper)
        value = _param_value(node, ctx)
        dim = node.get("dimension")
        if dim and np.ndim(value) == 0:
            value = np.full(int(dim), float(value))
    else:
        pid = None
        value = _param_value(node, ctx)
    name = name or pid
    if np.ndim(value) == 0:
        spec = ParamSpec.scalar(name, value, lower=lower, upper=upper)
    else:
        spec = ParamSpec.vector(name, value, lower=lower, upper=upper)
    if pid:
        ctx.param_names[pid] = name
        ctx.register(pid, spec)
    return spec


def build_simplex_spec(node, ctx: Context, name=None):
    node = ctx.resolve(node)
    if isinstance(node, ParamSpec):
        return node
    pid = node.get("id")
    name = name or pid
    if "values" in node:
        values = np.asarray(node["values"], dtype=np.float64)
    else:
        values = np.full(int(node["dimension"]), 1.0 / int(node["dimension"]))
    spec = ParamSpec.simplex(name, values)
    if pid:
        ctx.simplex_names[pid] = name
        ctx.param_names[pid] = name
        ctx.register(pid, spec)
    return spec


# -- data -------------------------------------------------------------------


def build_datatype(node, ctx: Context):
    node = ctx.resolve(node)
    if node is None:
        return get_datatype("nucleotide")
    if isinstance(node, str):
        return get_datatype(node)
    if isinstance(node, dict):
        if node.get("type", "").lower() == "datatype" or "states" in node:
            states = node["states"]
            ambiguities = node.get("ambiguities")
            dt = GeneralDataType(states, ambiguities)
            ctx.register(node.get("id"), dt)
            return dt
        raise ValueError(f"bad datatype node {node!r}")
    return node


def build_sitepattern(node, ctx: Context) -> SitePattern:
    node = ctx.resolve(node)
    if isinstance(node, SitePattern):
        return node
    dt = build_datatype(node.get("datatype"), ctx)
    aln_node = ctx.resolve(node["alignment"])
    if isinstance(aln_node, dict):
        if "file" in aln_node:
            seqs = read_alignment(ctx.path(aln_node["file"]))
        elif "sequences" in aln_node:
            seqs = aln_node["sequences"]
        else:
            raise ValueError("alignment needs 'file' or 'sequences'")
        ctx.register(aln_node.get("id"), seqs)
    else:
        seqs = aln_node
    gc = 0
    if isinstance(node.get("datatype"), dict):
        gc = int(node["datatype"].get("genetic_code", 0) or 0)
    sp = SitePattern.from_alignment(seqs, dt, genetic_code=gc)
    ctx.register(node.get("id"), sp)
    return sp


# -- substitution models ----------------------------------------------------


_NUC_RATE_ORDER = ["ac", "ag", "at", "cg", "ct", "gt"]


def build_substitution_model(node, ctx: Context) -> SubstitutionModel:
    node = ctx.resolve(node)
    if isinstance(node, SubstitutionModel):
        return node
    mid = node.get("id", "sm")
    model = str(node.get("model", "jc69")).lower()
    dt = build_datatype(node.get("datatype"), ctx)
    prefix = f"{mid}."

    freqs_node = node.get("frequencies")
    freqs_init = None
    freqs_name = None
    if freqs_node is not None:
        fspec = build_simplex_spec(freqs_node, ctx, name=None)
        freqs_init = np.asarray(fspec.init)
        freqs_name = fspec.name

    rates_node = node.get("rates")

    def rate_value(key, default):
        if isinstance(rates_node, dict) and key in rates_node:
            return _param_value(rates_node[key], ctx, default)
        return default

    if model == "jc69":
        sm = JC69(prefix)
    elif model == "k80":
        sm = K80(prefix)
    elif model == "f81":
        sm = F81(prefix, freqs_init=freqs_init)
    elif model == "hky":
        sm = HKY(prefix, kappa_init=rate_value("kappa", 1.0),
                 freqs_init=freqs_init)
    elif model == "gtr":
        if isinstance(rates_node, dict):
            vals = [rate_value(k, 1.0) for k in _NUC_RATE_ORDER]
            rates_init = np.asarray(vals, dtype=np.float64)
            sm = GTR(prefix, rates_init=rates_init, freqs_init=freqs_init)
        elif isinstance(rates_node, str) and rates_node.startswith("$"):
            sid = rates_node[1:]
            spec = ctx.objects[sid]
            sm = GTR(prefix, rates_init=np.asarray(spec.init),
                     freqs_init=freqs_init, rates_simplex=True)
        else:
            sm = GTR(prefix, freqs_init=freqs_init)
    elif model == "unrest":
        sm = UNREST(prefix)
    elif model == "nonstat":
        sm = NONSTAT(prefix)
    elif model in ("wag", "lg", "dayhoff"):
        from ..models.protein import EmpiricalProtein

        sm = EmpiricalProtein(model, prefix, freqs_init=freqs_init)
    elif model in ("mg94", "gy94"):
        from ..models.codon import MG94, GY94

        gc = int(node.get("datatype", {}).get("genetic_code", 0)
                 if isinstance(node.get("datatype"), dict) else 0)
        kw = dict(prefix=prefix, genetic_code=gc, freqs_init=freqs_init)
        sm = MG94(**kw) if model == "mg94" else GY94(**kw)
    elif set(model) <= set("012345") and len(model) == 5:
        # 5-digit rate-class code over AC,AG,AT,CG,CT (+GT fixed)
        # (reference: src/phyc/substmodel.c:1431-1533, nucsubst.c)
        mapping = [int(c) for c in model] + [int(max(model)) + 1]
        # last class (gt) fixed at 1 by convention: use GeneralReversible
        sm = GeneralReversible(4, np.asarray(mapping), prefix,
                               freqs_init=freqs_init)
    else:
        raise ValueError(f"unknown substitution model {model!r}")

    # rename spec keys to honor JSON parameter ids
    if freqs_name is not None and hasattr(sm, "freqs_init"):
        ctx.param_names[freqs_name] = sm.key("frequencies")
        ctx.simplex_names[freqs_name] = sm.key("frequencies")
    if isinstance(rates_node, dict):
        for key, sub in rates_node.items():
            if isinstance(sub, dict) and sub.get("id"):
                if model == "hky":
                    ctx.param_names[sub["id"]] = sm.key("kappa")
                else:
                    ctx.param_names[sub["id"]] = sm.key("rates")
    ctx.register(mid, sm)
    return sm


# -- site models ------------------------------------------------------------


def build_sitemodel(node, ctx: Context):
    node = ctx.resolve(node)
    if node is None:
        return ConstantSiteModel(), None
    subst = None
    if "substitutionmodel" in node:
        subst = build_substitution_model(node["substitutionmodel"], ctx)
    mid = node.get("id", "sitemodel")
    prefix = f"{mid}."
    dist_node = node.get("distribution")
    mu = "mu" in node
    mu_init = _param_value(node["mu"], ctx, 1.0) if mu else 1.0

    if dist_node is None:
        sm = ConstantSiteModel(prefix, mu=mu, mu_init=mu_init)
    else:
        if isinstance(dist_node, str):
            dist_name, cats, shape_init, quad = dist_node.lower(), 4, 0.5, "median"
            invariant = False
            props = None
        else:
            dist_name = str(dist_node.get("distribution", "gamma")).lower()
            cats = int(dist_node.get("categories", 4))
            quad = str(dist_node.get("quadrature", "median")).lower()
            invariant = bool(dist_node.get("invariant", False))
            props = dist_node.get("proportions")
            pnode = dist_node.get("parameters")
            shape_init = 0.5
            if isinstance(pnode, dict):
                if "alpha" in pnode or "shape" in pnode:
                    shape_init = _param_value(
                        pnode.get("alpha", pnode.get("shape")), ctx, 0.5)
                elif "id" in pnode:
                    shape_init = _param_value(pnode, ctx, 0.5)
        # sitemodel-level "rates": {"alpha": {...}} (gtr-bayesian.json style)
        if "rates" in node and isinstance(node["rates"], dict):
            rn = node["rates"]
            if "alpha" in rn or "shape" in rn:
                shape_init = _param_value(rn.get("alpha", rn.get("shape")),
                                          ctx, shape_init)
        pinv_init = 0.1
        if props is not None:
            pspec = build_simplex_spec(props, ctx)
            pinv_init = float(np.asarray(pspec.init)[0])
            invariant = True
        if dist_name == "discrete":
            sm = DiscreteSiteModel(cats, prefix, mu=mu, mu_init=mu_init)
        else:
            sm = QuantileSiteModel(
                cats, dist_name, invariant, quad, prefix,
                shape_init=shape_init, pinv_init=pinv_init, mu=mu,
                mu_init=mu_init)
        # register shape parameter id
        def reg_shape(pnode):
            if isinstance(pnode, dict):
                if "id" in pnode:
                    ctx.param_names[pnode["id"]] = sm.key("shape")
                else:
                    for sub in pnode.values():
                        if isinstance(sub, dict) and "id" in sub:
                            ctx.param_names[sub["id"]] = sm.key("shape")
        if isinstance(dist_node, dict):
            reg_shape(dist_node.get("parameters"))
        reg_shape(node.get("rates"))
    ctx.register(mid, sm)
    return sm, subst


# -- trees ------------------------------------------------------------------


def build_tree(node, ctx: Context):
    """Returns a TreeHandle.

    Mirrors new_TreeModel_from_json (reference: src/phyc/tree.c:1183-1300).
    """
    from .treehandle import TreeHandle

    node = ctx.resolve(node)
    if isinstance(node, TreeHandle):
        return node
    time_tree = bool(node.get("time", False))
    dates = node.get("dates")
    if "newick" in node or "file" in node:
        if "newick" in node:
            topo, distances = read_newick(node["newick"])
        else:
            topo, distances = read_newick(ctx.path(node["file"]))
    elif "init" in node:
        init = node["init"]
        algorithm = str(init.get("algorithm", "nj")).lower()
        sp = build_sitepattern(init["sitepattern"], ctx)
        # reference quirk: inverted strcasecmp chain means model=="uncorrected"
        # builds JC69 distances and anything else builds uncorrected ones
        # (reference: src/phyc/distancematrix.c create_DistanceMatrix_from_json)
        model = str(init.get("model", "uncorrected")).lower()
        actual = "jc69" if model == "uncorrected" else "uncorrected"
        if sp.datatype.state_count == 20:
            # amino-acid data always uses the protein Kimura correction
            # (reference: distancematrix.c:641-646 SitePattern_distance)
            actual = "kimura"
        D = distance_matrix(sp, actual)
        topo, distances = (nj if algorithm == "nj" else upgma)(sp.taxa, D)
    else:
        raise ValueError("tree node needs newick/file/init")
    td = None
    if dates is not None or time_tree:
        td = TimeTreeData.from_dated_tree(topo, distances, dates)
    # prefix derives from the JSON id so several trees (partitioned
    # analyses, reference SitePattern_split use case) coexist in one pytree
    tid = node.get("id", "tree")
    transform = str(node.get("transform", "ratio")).lower()
    handle = TreeHandle(topo, distances, td, prefix=f"{tid}.")
    handle.transform = transform
    ctx.register(tid, handle)
    # parameter-name aliases declared on the tree node
    # (reference: tree.c:1183-1199 allowed keys; examples use e.g.
    #  "reparam": "tree.scalers", "ratios": "tree.ratios")
    if td is not None:
        if transform == "shift":
            reparam_specs = [handle.key("shifts")]
            alias_map = (("reparam", reparam_specs),
                         ("heights", reparam_specs))
        else:
            reparam_specs = [handle.key("ratios"), handle.key("root_height")]
            alias_map = (
                ("reparam", reparam_specs),
                ("ratios", [handle.key("ratios")]),
                ("root_height", [handle.key("root_height")]),
                ("heights", reparam_specs),
            )
        for key, specs in alias_map:
            alias = node.get(key)
            if isinstance(alias, str):
                ctx.slices[alias] = specs
        for specs in alias_map:
            for s in specs[1]:
                ctx.slices.setdefault(s, [s])
    else:
        alias = node.get("parameters")
        if isinstance(alias, str):
            ctx.slices[alias] = [handle.key("distances")]
        ctx.slices.setdefault(handle.key("distances"),
                              [handle.key("distances")])
    return handle


# -- branch/clock models ----------------------------------------------------


def build_branchmodel(node, ctx: Context, N: int):
    node = ctx.resolve(node)
    model = str(node.get("model", "strict")).lower()
    mid = node.get("id", "bm")
    prefix = f"{mid}."
    if model == "strict":
        rate_node = node.get("rate")
        rate_init = _param_value(rate_node, ctx, 1e-3) if rate_node is not None else 1e-3
        bm = StrictClock(N, prefix, rate_init=float(rate_init))
        if isinstance(rate_node, dict) and rate_node.get("id"):
            ctx.param_names[rate_node["id"]] = bm.key("rate")
    elif model in ("discrete", "local"):
        cmap = np.zeros(N, dtype=np.int32)
        if "map" in node:
            cmap = np.asarray(node["map"], dtype=np.int32)
        bm = DiscreteClock(N, cmap, prefix)
    elif model == "relaxed":
        # "distribution" selects the reference's discretized relaxed-clock
        # families (branchmodel.h:33); without one, free per-branch rates
        dist = node.get("distribution")
        if dist:
            from ..models.clock import DistributionRelaxedClock

            pnode = node.get("parameters", {})
            kw = {}
            if isinstance(pnode, dict):
                for jk, attr in (("logmean", "logmean_init"),
                                 ("mean", "logmean_init"),
                                 ("logsigma", "logsigma_init"),
                                 ("sigma", "logsigma_init"),
                                 ("lambda", "lambda_init"),
                                 ("rate", "lambda_init"),
                                 ("center", "center_init")):
                    if jk in pnode:
                        kw[attr] = float(_param_value(pnode[jk], ctx))
                        sub = pnode[jk]
                        if isinstance(sub, dict) and sub.get("id"):
                            ctx.param_names[sub["id"]] = f"{prefix}" + (
                                "logmean" if attr == "logmean_init" else
                                "logsigma" if attr == "logsigma_init" else
                                "lambda" if attr == "lambda_init" else
                                "center")
            if "categories" in node:
                kw["n_cats"] = int(node["categories"])
            if "map" in node:
                kw["assignment"] = np.asarray(node["map"], dtype=np.int32)
            bm = DistributionRelaxedClock(N, dist, prefix, **kw)
        else:
            bm = RelaxedClock(N, prefix)
    else:
        raise ValueError(f"unknown branch model {model!r}")
    ctx.register(mid, bm)
    return bm


# -- tree likelihood --------------------------------------------------------


def build_treelikelihood(node, ctx: Context) -> TreeLikelihood:
    node = ctx.resolve(node)
    if isinstance(node, TreeLikelihood):
        return node
    sp = build_sitepattern(node["sitepattern"], ctx)
    site_model, subst = build_sitemodel(node.get("sitemodel"), ctx)
    if subst is None:
        subst = build_substitution_model(node["substitutionmodel"], ctx)
    handle = build_tree(node["tree"], ctx)
    topo, distances, td = handle.topo, handle.distances, handle.td
    clock = None
    if "branchmodel" in node:
        clock = build_branchmodel(node["branchmodel"], ctx, topo.N)
    elif td is not None:
        clock = StrictClock(topo.N, "bm.", rate_init=1e-3)
    dist0 = np.nan_to_num(np.asarray(distances)[: topo.N - 1], nan=0.1)
    tid = node.get("id", "treelikelihood")
    # mesh runs pad the pattern axis to a multiple of the pattern-mesh size
    # (padded patterns carry zero weight, so this is exact)
    pad = int(node.get("pattern_pad_multiple", 1))
    n_pat = getattr(ctx, "pattern_devices", 1)
    if n_pat > 1:
        pad = math.lcm(pad, n_pat)
    tlk = TreeLikelihood(
        sp, topo, subst, site_model, clock=clock, time_data=td,
        distances_init=dist0,
        include_jacobian=bool(node.get("include_jacobian",
                                       node.get("reparameterized", False))),
        # the reference DEFAULTS tipstates to true (treelikelihood.c:841):
        # ambiguity codes collapse to unknown unless "tipstates": false.
        # Verified on fluA (one 'R'): reference logP is identical for R and
        # N, and differs once tipstates:false uses real ambiguity partials.
        tipstates=bool(node.get("tipstates", True)),
        prefix=handle.prefix,
        pattern_pad_multiple=pad,
        height_transform=getattr(handle, "transform", "ratio"),
    )
    ctx.param_names.setdefault(handle.key("distances"),
                               handle.key("distances"))
    ctx.register(tid, tlk)
    return tlk


def build_parsimony(node, ctx: Context):
    """Parsimony model (reference: src/physher.c:190 MODEL_PARSIMONY)."""
    from ..likelihood.parsimony import Parsimony

    node = ctx.resolve(node)
    if not isinstance(node, dict):
        return node
    sp = build_sitepattern(node["sitepattern"], ctx)
    handle = build_tree(node["tree"], ctx)
    pars = Parsimony(sp, handle.topo)
    ctx.register(node.get("id"), pars)
    return pars


BUILDERS = {
    "treelikelihood": build_treelikelihood,
    "sitepattern": build_sitepattern,
    "substitutionmodel": build_substitution_model,
    "tree": build_tree,
    "parsimony": build_parsimony,
}


def build_config(cfg: dict, base_dir: str = ".", devices=None):
    """Build every top-level model object; returns (Context, actions list).

    Multi-device runs are declared in the config's ``init`` block (the
    reference's seed block, src/physher.c:152) or via ``devices``:

    - ``"init": {"devices": 4}`` — shard site patterns over 4 devices
      (the reference's SIMD/OpenMP pattern axis, reborn as a mesh axis);
    - ``"init": {"mesh": {"chains": 2, "patterns": 4}}`` — 2-D mesh:
      MCMC chains / tempered-ladder replicas on 'chains', patterns on
      'patterns'.

    ``devices`` (int or {"chains":c,"patterns":p}) overrides the config
    (the CLI --devices/--mesh flags). Every TreeLikelihood is built with a
    compatible pattern padding and sharded via
    parallel.mesh.shard_tree_likelihood; drivers read ``ctx.mesh``.
    """
    cfg = _prune(copy.deepcopy(cfg))
    ctx = Context(base_dir)
    actions = cfg.pop("physher", [])
    init = cfg.pop("init", {})
    ctx.seed = int(init.get("seed", 0)) if isinstance(init, dict) else 0
    ctx.mesh = None
    ctx.mesh_shape = None
    req = devices if devices is not None else (
        init.get("mesh", init.get("devices"))
        if isinstance(init, dict) else None)
    if req is not None:
        if isinstance(req, dict):
            shape = {"chains": int(req.get("chains", 1)),
                     "patterns": int(req.get("patterns", 1))}
        else:
            shape = {"chains": 1, "patterns": int(req)}
        ctx.mesh_shape = shape
        # builders read this to pick a shard-compatible pattern padding
        ctx.pattern_devices = shape["patterns"]
    for key, node in cfg.items():
        if not isinstance(node, dict):
            continue
        typ = str(node.get("type", "")).lower()
        if typ in BUILDERS:
            BUILDERS[typ](node, ctx)
        elif typ == "compound":
            from .compound import build_compound

            build_compound(node, ctx)
        elif typ == "simplex":
            build_simplex_spec(node, ctx)
        elif typ == "parameter":
            build_parameter_spec(node, ctx)
        elif typ == "variational":
            from .variational import build_variational

            build_variational(node, ctx)
        elif typ == "distribution":
            from .compound import build_distribution

            build_distribution(node, ctx)
        elif typ in ("coalescent",):
            from .compound import build_coalescent

            build_coalescent(node, ctx)
        else:
            raise ValueError(f"unknown model type {typ!r} for {key!r}")
    if ctx.mesh_shape is not None:
        _attach_mesh(ctx)
    return ctx, actions


def _attach_mesh(ctx: Context):
    """Create the device mesh declared in the config and shard every
    TreeLikelihood's pattern-indexed constants over it (reduction point:
    the weighted root sum, reference src/phyc/treelikelihood.c:1483-1486)."""
    import jax

    from ..models.treelikelihood import TreeLikelihood
    from ..parallel.mesh import chain_pattern_mesh, pattern_mesh, \
        shard_tree_likelihood

    shape = ctx.mesh_shape
    total = shape["chains"] * shape["patterns"]
    devs = jax.devices()
    if len(devs) < total:
        raise ValueError(
            f"config requests a {shape['chains']}x{shape['patterns']} mesh "
            f"but only {len(devs)} devices are visible (set XLA_FLAGS="
            f"--xla_force_host_platform_device_count={total} for a virtual "
            f"CPU mesh)")
    if shape["chains"] > 1:
        ctx.mesh = chain_pattern_mesh(shape["chains"], devices=devs[:total])
        ctx.chain_axis = "chains"
    else:
        ctx.mesh = pattern_mesh(devices=devs[:total])
        ctx.chain_axis = None
    for obj in ctx.objects.values():
        if isinstance(obj, TreeLikelihood):
            shard_tree_likelihood(obj, ctx.mesh)
