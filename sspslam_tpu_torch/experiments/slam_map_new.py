"""Semantic mapping demo on the port: the flags, printed lines and output
figure of the JAX package's ``experiments/slam_map_new.py``, with
``--device`` (default ``cuda``) naming where the simulation runs
(``--backend cpu`` is ``--device cpu``).

    python -m sspslam_tpu_torch.experiments.slam_map_new [--device cpu]

* items carry structured identities (shape SP bound with colour SP);
* walls are spatially-extended landmarks encoded as the 2-D integral of
  SSPs over their region (grid quadrature);
* the SLAM network learns identity -> location while a second *inverse*
  associative memory learns location -> identity;
* after the run, the maps are queried offline: single items, compositional
  queries ("the blue triangle", "all blue objects", "all triangles",
  "the walls") and an area query through the inverse memory.

:func:`simulate` builds and runs the network and answers the queries on
the host (it needs no matplotlib); :func:`render` draws the figure.
"""

import argparse
import os
import time

import numpy as np

from ..models import AssociativeMemory, SLAMNetwork
from ..nef import Connection, Network, Node, Probe, Simulator, WhiteSignal
from ..sspspace import HexagonalSSPSpace, SPSpace
from ..utils import uniform_hypersphere
from .common import DT


def region_integral_ssp(ssp_space, bounds, n_quad=60):
    """Integral of phi(x) over an axis-aligned rectangle via grid
    quadrature."""
    xs = np.linspace(bounds[0, 0], bounds[0, 1], n_quad)
    ys = np.linspace(bounds[1, 0], bounds[1, 1], n_quad)
    X, Y = np.meshgrid(xs, ys)
    phis = ssp_space.encode(np.stack([X.reshape(-1), Y.reshape(-1)], axis=1))
    area = ((bounds[0, 1] - bounds[0, 0]) * (bounds[1, 1] - bounds[1, 0]))
    return phis.mean(axis=0) * area


def vec_to_walls(path, wall_boundaries):
    """Closest-point vectors from each path point to each wall rectangle."""
    px = path[:, None, 0]
    py = path[:, None, 1]
    cx = np.clip(px, wall_boundaries[None, :, 0, 0],
                 wall_boundaries[None, :, 0, 1])
    cy = np.clip(py, wall_boundaries[None, :, 1, 0],
                 wall_boundaries[None, :, 1, 1])
    return np.stack([cx - px, cy - py], axis=-1)


def parse_args(argv=None):
    parser = argparse.ArgumentParser(
        formatter_class=argparse.ArgumentDefaultsHelpFormatter)
    parser.add_argument("--T", default=60.0, type=float)
    parser.add_argument("--seed", default=0, type=int)
    parser.add_argument("--view-rad", default=0.3, type=float)
    parser.add_argument("--pi-n-neurons", default=250, type=int)
    parser.add_argument("--circonv-n-neurons", default=100, type=int)
    parser.add_argument("--n-scales", default=8, type=int)
    parser.add_argument("--n-rotates", default=5, type=int)
    parser.add_argument("--backend", default="jit",
                        help="cpu: --device cpu; any other name runs the "
                             "Simulator on --device")
    parser.add_argument("--device", default="cuda", type=str,
                        help="torch device the simulation runs on "
                             "(cuda | cpu)")
    parser.add_argument("--save-dir", default="figures")
    args = parser.parse_args(argv)
    if args.backend == "cpu":
        args.device = "cpu"
    return args


def build(args):
    """The world (path, items, walls, their input tables), the SLAM network
    with its inverse memory, and the Simulator on ``args.device``."""
    seed = args.seed
    dt = DT
    T = args.T
    radius = 1.0
    domain_dim = 2
    bounds = radius * np.tile([-1, 1], (domain_dim, 1))
    ssp_space = HexagonalSSPSpace(domain_dim, n_scales=args.n_scales,
                                  n_rotates=args.n_rotates,
                                  domain_bounds=1.2 * bounds,
                                  length_scale=0.3, seed=seed)
    d = ssp_space.ssp_dim

    # trajectory
    path = np.hstack([WhiteSignal(T, high=0.05, seed=s).run(T, dt=dt)
                      for s in (0, 1)])
    for i in range(2):
        lo, hi = path[:, i].min(), path[:, i].max()
        path[:, i] = (path[:, i] - lo) / max(hi - lo, 1e-12) * 1.8 - 0.9
    pathlen = path.shape[0]
    vels = (1 / dt) * np.diff(path, axis=0, prepend=path[:1])
    real_ssp = ssp_space.encode(path)
    real_inv_ssp = ssp_space.invert(real_ssp)

    # items: shape (x) colour bound identities
    item_locations = np.array([[-0.8, -0.5], [0.0, -0.6],
                               [-0.2, 0.2], [0.6, 0.2]])
    n_items = len(item_locations)
    item_shapes = ["triangle", "triangle", "square", "square"]
    item_cols = ["blue", "orange", "blue", "orange"]
    shape_names = sorted(set(item_shapes))
    col_names = sorted(set(item_cols))
    rng0 = np.random.RandomState(seed)
    shape_sps = uniform_hypersphere(len(shape_names), d, rng0, surface=True)
    col_sps = uniform_hypersphere(len(col_names), d,
                                  np.random.RandomState(seed + 10),
                                  surface=True)
    shape_idx = [shape_names.index(s) for s in item_shapes]
    col_idx = [col_names.index(c) for c in item_cols]
    item_sps = ssp_space.bind(shape_sps[shape_idx], col_sps[col_idx])
    vec_to_items = item_locations[None, :, :] - path[:, None, :]

    # walls as spatially-extended landmarks
    wall_boundaries = np.array([[[-1.1, -0.95], [0.2, 1.1]],
                                [[-0.95, -0.0], [0.95, 1.1]]])
    n_walls = len(wall_boundaries)
    wall_sps = uniform_hypersphere(n_walls, d,
                                   np.random.RandomState(seed + 20),
                                   surface=True)
    wall_ssps = np.stack([region_integral_ssp(ssp_space, wb)
                          for wb in wall_boundaries])
    wall_ssps = np.stack([ssp_space.normalize(w) for w in wall_ssps])

    lm_space = SPSpace(n_items + n_walls, d, seed=seed,
                       vectors=np.vstack([item_sps, wall_sps]))
    landmark_sps = lm_space.vectors
    vel_scaling_factor = 1 / np.max(np.abs(ssp_space.phase_matrix @ vels.T))
    vels_scaled = vels * vel_scaling_factor

    vtw = vec_to_walls(path, wall_boundaries)
    all_vecs = np.concatenate([vec_to_items, vtw], axis=1)  # (T, L, 2)
    dists = np.linalg.norm(all_vecs, axis=2)
    nearest = np.argmin(dists, axis=1)
    in_view = dists[np.arange(pathlen), nearest] <= args.view_rad
    lm_ids = np.where(in_view, nearest, -1)

    # landmark vec-SSPs: items use phi(vec); walls use phi(-x) (*) wall_ssp
    item_vec_ssps = ssp_space.encode(
        all_vecs[np.arange(pathlen), np.minimum(nearest, n_items - 1)])
    wall_view = np.zeros((pathlen, d))
    wall_sel = nearest - n_items
    mask_wall = (nearest >= n_items) & in_view
    if mask_wall.any():
        idxs = np.where(mask_wall)[0]
        wall_view[idxs] = ssp_space.bind(real_inv_ssp[idxs],
                                         wall_ssps[wall_sel[idxs]])

    def step_of(t):
        return min(max(int(round((t - dt) / dt)), 0), pathlen - 1)

    def velocity_func(t):
        return vels_scaled[step_of(t)]

    def landmark_sp_func(t):
        i = step_of(t)
        return landmark_sps[lm_ids[i]] if lm_ids[i] >= 0 else np.zeros(d)

    def landmark_vecssp_func(t):
        i = step_of(t)
        if lm_ids[i] < 0:
            return np.zeros(d)
        if lm_ids[i] < n_items:
            return item_vec_ssps[i]
        return wall_view[i]

    def is_landmark_in_view(t):
        return 0.0 if lm_ids[step_of(t)] >= 0 else 10.0

    mem_n_neurons = 10 * d
    intercept = min((item_sps @ item_sps.T - np.eye(n_items)).max(), 0.5)

    with Network(seed=seed) as model:
        vel_input = Node(velocity_func, label="vel_input")
        init_state = Node(lambda t: real_ssp[0] if t < 0.05 else np.zeros(d))
        landmark_vec = Node(landmark_vecssp_func)
        landmark_id = Node(landmark_sp_func)
        is_landmark = Node(is_landmark_in_view)
        slam = SLAMNetwork(ssp_space, lm_space, args.view_rad,
                           n_items + n_walls, args.pi_n_neurons,
                           mem_n_neurons, args.circonv_n_neurons,
                           tau_pi=0.05, update_thres=0.2,
                           vel_scaling_factor=vel_scaling_factor,
                           shift_rate=0.1, voja_learning_rate=5e-4,
                           pes_learning_rate=5e-3, seed=seed)
        Connection(landmark_vec, slam.landmark_vec_ssp, synapse=None)
        Connection(landmark_id, slam.landmark_id_input, synapse=None)
        Connection(is_landmark, slam.no_landmark_in_view, synapse=None)
        Connection(vel_input, slam.velocity_input, synapse=None)
        Connection(init_state, slam.pathintegrator.input, synapse=None)

        # second, inverse associative memory: location-SSP -> identity-SP
        invassomemory = AssociativeMemory(
            mem_n_neurons, d, d, min(intercept, 0.1),
            voja_learning_rate=5e-4, pes_learning_rate=1e-2, voja=True,
            encoders=ssp_space.sample_grid_encoders(mem_n_neurons),
            radius=1.3)
        Connection(slam.landmark_ssp_ens.output, invassomemory.key_input,
                   synapse=0.05)
        Connection(landmark_id, invassomemory.value_input, synapse=None)
        Connection(is_landmark, invassomemory.learning, synapse=None)

        ssp_p = Probe(slam.pathintegrator.output, synapse=0.05)
        mem_weights = Probe(slam.assomemory.conn_out, attr="weights",
                            sample_every=1.0)
        mem_encoders = Probe(slam.assomemory.conn_in.learning_rule,
                             attr="scaled_encoders", sample_every=1.0)
        meminv_weights = Probe(invassomemory.conn_out, attr="weights",
                               sample_every=T)
        meminv_encoders = Probe(invassomemory.conn_in.learning_rule,
                                attr="scaled_encoders", sample_every=T)

    sim = Simulator(model, seed=seed, progress=True, device=args.device)
    memories = [next(b for b in sim.model.ensembles if b.obj is mem)
                for mem in (slam.assomemory.memory, invassomemory.memory)]
    return {"sim": sim, "T": T, "space": ssp_space, "path": path,
            "real_ssp": real_ssp, "memories": memories,
            "probes": (ssp_p, mem_weights, mem_encoders, meminv_weights,
                       meminv_encoders),
            "items": (item_locations, item_shapes, item_cols, item_sps),
            "names": (shape_names, col_names, shape_sps, col_sps),
            "landmark_sps": landmark_sps, "wall_sps": wall_sps,
            "wall_boundaries": wall_boundaries}


def simulate(args, built=None):
    """Run ``built`` (default: :func:`build` of ``args``) for T seconds,
    then answer the offline queries on the host from the final probed PES
    decoders and Voja encoders of both memories.  Returns a dict: the
    tracking trace and the queries' numbers, ``lines`` (the lines the JAX
    script prints before its figure), what :func:`render` draws, and the
    run's wall seconds and steps/s."""
    built = built or build(args)
    sim, T, ssp_space = built["sim"], built["T"], built["space"]
    (ssp_p, mem_weights, mem_encoders, meminv_weights,
     meminv_encoders) = built["probes"]
    item_locations, item_shapes, item_cols, item_sps = built["items"]
    shape_names, col_names, shape_sps, col_sps = built["names"]
    landmark_sps, real_ssp = built["landmark_sps"], built["real_ssp"]
    n_items = len(item_locations)
    pathlen = built["path"].shape[0]
    n_steps = int(round(T / DT))
    sim.preload_inputs(n_steps)
    sim.compile(n_steps)
    t0 = time.perf_counter()
    sim.run(T)
    sim.sync()
    seconds = time.perf_counter() - t0

    # ---- offline readout machinery -------------------------------------
    be_mem, be_inv = built["memories"]
    dec_mem = sim.data[mem_weights][-1].T
    dec_inv = sim.data[meminv_weights][-1].T
    enc_mem = sim.data[mem_encoders][-1]
    enc_inv = sim.data[meminv_encoders][-1]

    def get_mem_out(x):
        J = np.atleast_2d(x) @ enc_mem.T + be_mem.bias
        return be_mem.neuron_type.rates_np(J) @ dec_mem

    def get_mem_out2(x):
        J = np.atleast_2d(x) @ enc_inv.T + be_inv.bias
        return be_inv.neuron_type.rates_np(J) @ dec_inv

    lines = []
    # tracking quality
    out = sim.data[ssp_p]
    sims = np.sum(out * real_ssp, axis=1) / np.maximum(
        np.linalg.norm(out, axis=1), 1e-6)
    tracking = float(np.mean(sims[pathlen // 2:]))
    lines.append(f"tracking cosine sim (mean, last half): {tracking:.3f}")

    # ---- semantic queries ------------------------------------------------
    sample_ssps, sample_points = ssp_space.get_sample_pts_and_ssps(100)

    def decode_map(v):
        sims_v = sample_ssps @ np.asarray(v).reshape(-1)
        return sample_points[np.argmax(sims_v)]

    item_ssp_hat = get_mem_out(landmark_sps[:n_items])
    errs = np.linalg.norm(
        np.stack([decode_map(item_ssp_hat[i]) for i in range(n_items)])
        - item_locations, axis=1)
    names = [f"{c} {s}" for c, s in zip(item_cols, item_shapes)]
    for nm, e in zip(names, errs):
        lines.append(f"  map[{nm}]: location error {e:.3f}")

    # compositional queries
    q_blue_tri = ssp_space.normalize(ssp_space.bind(
        shape_sps[shape_names.index("triangle")],
        col_sps[col_names.index("blue")]).flatten())
    q_all_blue = ssp_space.normalize(ssp_space.bind(
        col_sps[col_names.index("blue")], np.sum(shape_sps, axis=0)).flatten())
    q_all_tri = ssp_space.normalize(ssp_space.bind(
        shape_sps[shape_names.index("triangle")],
        np.sum(col_sps, axis=0)).flatten())
    q_walls = ssp_space.normalize(np.sum(built["wall_sps"], axis=0))

    blue_tri_loc = decode_map(get_mem_out(q_blue_tri))
    true_blue_tri = item_locations[0]
    blue_tri_err = float(np.linalg.norm(blue_tri_loc - true_blue_tri))
    lines.append(f"  query 'blue triangle' -> {blue_tri_loc}, true "
                 f"{true_blue_tri}, err {blue_tri_err:.3f}")

    # area query through the inverse memory
    query_area = np.array([[-0.5, 0.8], [-0.3, 0.5]])
    qX, qY = np.meshgrid(np.linspace(*query_area[0], 20),
                         np.linspace(*query_area[1], 20))
    q_ssp = ssp_space.encode(np.stack([qX.reshape(-1), qY.reshape(-1)],
                                      axis=1))
    q_ssp = ssp_space.normalize(np.sum(q_ssp, axis=0))
    item_sp_hat = get_mem_out2(q_ssp)
    area_sims = (item_sp_hat @ item_sps.T).flatten()
    in_area = [(query_area[0, 0] <= x <= query_area[0, 1]
                and query_area[1, 0] <= y <= query_area[1, 1])
               for x, y in item_locations]
    lines.append(f"  area query sims: {np.round(area_sims, 2)} "
                 f"(true in-area: {in_area})")

    queries = [("blue triangle", q_blue_tri), ("all blue", q_all_blue),
               ("all triangles", q_all_tri), ("walls", q_walls)]
    return {"out": out, "sims": sims, "tracking": tracking,
            "item_errors": errs, "blue_triangle": blue_tri_loc,
            "blue_triangle_error": blue_tri_err, "area_sims": area_sims,
            "in_area": in_area, "lines": lines,
            "query_maps": [(nm, get_mem_out(q).reshape(-1))
                           for nm, q in queries],
            "space": ssp_space, "path": built["path"],
            "items": (item_locations, item_shapes, item_cols),
            "wall_boundaries": built["wall_boundaries"],
            "seconds": seconds, "steps_per_s": n_steps / seconds}


def render(res, save_dir):
    """The environment, the cosine error and the four query maps
    (matplotlib); writes ``<save_dir>/slam_map_queries.png``."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    from matplotlib.patches import Rectangle

    path, sims = res["path"], res["sims"]
    item_locations, item_shapes, item_cols = res["items"]
    os.makedirs(save_dir, exist_ok=True)
    fig, axs = plt.subplots(2, 3, figsize=(10, 6))
    ax = axs[0, 0]
    ax.plot(path[:, 0], path[:, 1], "k", lw=1)
    markers = {"triangle": "^", "square": "s"}
    for i in range(len(item_locations)):
        ax.plot(*item_locations[i], markers[item_shapes[i]],
                color=item_cols[i], ms=9)
    for wb in res["wall_boundaries"]:
        ax.add_patch(Rectangle((wb[0, 0], wb[1, 0]), wb[0, 1] - wb[0, 0],
                               wb[1, 1] - wb[1, 0], facecolor="k"))
    ax.set_title("environment"); ax.set_xlim(-1.2, 1.2); ax.set_ylim(-1.2, 1.2)
    ax = axs[0, 1]
    ax.plot(DT * np.arange(path.shape[0])[::50], 1 - sims[::50])
    ax.set_title("cosine error"); ax.set_xlabel("time (s)")
    for ax_, (nm, m) in zip(axs.flat[2:], res["query_maps"]):
        res["space"].similarity_plot(m, n_grid=60, plot_type="contourf",
                                     ax=ax_)
        ax_.set_title(nm)
    out_png = os.path.join(save_dir, "slam_map_queries.png")
    fig.savefig(out_png, dpi=120)
    plt.close(fig)
    print(f"saved {out_png}")


def main(argv=None):
    args = parse_args(argv)
    res = simulate(args)
    for line in res["lines"]:
        print(line)
    render(res, args.save_dir)
    return res


if __name__ == "__main__":
    main()
