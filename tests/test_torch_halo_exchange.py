"""The halo exchangers and the spatial-parallel bottleneck of the port in
a gloo world of 4 against the JAX package's under ``jax.shard_map`` over
4 of the 8 CPU devices of ``tests/conftest.py`` (the mirror of
``tests/test_halo_exchange.py``).

One gloo world of 4 CPU processes is spawned once for the file
(``test_torch_tensor_parallel.spawn_world``); rank ``r`` holds the
``r``-th of 4 slabs of the image height. Each exchanger's inputs (the
halos) are held bit for bit against the JAX exchangers' and against the
neighbouring slabs' rows (zeros at the chain's ends, the local halos
crossed over for NoComm); the gradients through SendRecv and AllGather
(a different cotangent on every rank) against JAX's autodiff of
``ppermute`` / ``all_gather``, bit for bit (they only move values);
``spatial_conv3x3`` forward, input and kernel gradients against the
dense conv; ``SpatialBottleneck`` (weights through
``convert.spatial_bottleneck_state_from_jax``, with and without the
downsample branch) forward against the JAX module under ``shard_map`` and
the dense flax ``Bottleneck``, its input and parameter gradients (the
parameters' summed over the ranks) against the dense block's, and its
new running statistics against the JAX module's.

Tolerances: exchanges exact; the convs ``atol=1e-5`` forward and
``rtol=1e-5, atol=1e-4`` for the gradients (the JAX test's); the
bottleneck forward ``atol=2e-5`` (the JAX test's), its gradients within
``1e-4`` of each leaf's largest entry and the running statistics
``atol=1e-6`` (fp32; the BatchNorm statistics are two-pass sums in
gloo's order against XLA's).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import Mesh, PartitionSpec as P

from apex_tpu.contrib.bottleneck import (
    Bottleneck as JBottleneck,
    HaloExchangerAllGather as JAllGather,
    HaloExchangerNoComm as JNoComm,
    HaloExchangerPeer as JPeer,
    HaloExchangerSendRecv as JSendRecv,
    SpatialBottleneck as JSpatialBottleneck,
    halo_pad_1d as jhalo_pad_1d,
    spatial_conv3x3 as jspatial_conv3x3,
)
from test_torch_tensor_parallel import flat, spawn_world, unflat

SP = 4
N, H, W, C = 2, 32, 16, 8
HL = H // SP
#: bottleneck variants: (in, mid, out)
VARIANTS = {"same": (C, 4, C), "down": (C, 4, 2 * C)}
EXCHANGERS = ("SendRecv", "AllGather", "Peer", "NoComm")


def _inputs():
    rng = np.random.default_rng(0)
    out = {"x": rng.normal(size=(N, H, W, C)).astype(np.float32),
           "w": (0.2 * rng.normal(size=(3, 3, C, C))).astype(np.float32),
           "cl": rng.normal(size=(SP, N, 2, W, C)).astype(np.float32),
           "cr": rng.normal(size=(SP, N, 2, W, C)).astype(np.float32),
           "cy": rng.normal(size=(N, H, W, C)).astype(np.float32)}
    for v, (cin, mid, cout) in VARIANTS.items():
        mod = JBottleneck(in_channels=cin, bottleneck_channels=mid,
                          out_channels=cout)
        p = mod.init(jax.random.PRNGKey(8), jnp.asarray(out["x"]))["params"]
        for k, a in flat(_spatial_params(p)).items():
            out[f"{v}/{k}"] = np.asarray(a)
        out[f"{v}/cot"] = rng.normal(size=(N, H, W, cout)).astype(np.float32)
    return out


def _spatial_params(dp):
    """The dense flax block's params in the spatial module's names."""
    p = {k: dict(v) for k, v in dp.items() if k != "conv2"}
    p["conv2_kernel"] = dp["conv2"]["kernel"]
    return p


ARR = _inputs()

_WORKER = r"""
import json, sys
import numpy as np
import torch
import torch.distributed as dist

torch.set_num_threads(1)
rank, world, store, out, inputs = (int(sys.argv[1]), int(sys.argv[2]),
                                   sys.argv[3], sys.argv[4], sys.argv[5])
spec = json.loads(sys.argv[6])
dist.init_process_group("gloo", init_method="file://" + store,
                        world_size=world, rank=rank)
from apex_tpu_torch.contrib import bottleneck as bn
from apex_tpu_torch.convert import (conv_kernel_from_jax,
                                    spatial_bottleneck_state_from_jax)

arr = dict(np.load(inputs))
res = {}
hl = spec["hl"]
x_all = torch.from_numpy(arr["x"])
x = x_all[:, rank * hl:(rank + 1) * hl].contiguous()

def unflat(prefix):
    tree = {}
    for k, v in arr.items():
        if k.startswith(prefix + "/") and not k.endswith("/cot"):
            node = tree
            *path, leaf = k[len(prefix) + 1:].split("/")
            for p in path:
                node = node.setdefault(p, {})
            node[leaf] = v
    return tree

for name in spec["exchangers"]:
    ex = getattr(bn, "HaloExchanger" + name)("spatial")
    li, ri = ex.left_right_halo_exchange(x[:, :1], x[:, -1:])
    res[f"{name}/li1"], res[f"{name}/ri1"] = li.numpy(), ri.numpy()
    xg = x.clone().requires_grad_(True)
    li, ri = ex.left_right_halo_exchange(xg[:, :2], xg[:, -2:])
    res[f"{name}/li2"], res[f"{name}/ri2"] = li.detach().numpy(), ri.detach().numpy()
    ((li * torch.from_numpy(arr["cl"][rank])).sum()
     + (ri * torch.from_numpy(arr["cr"][rank])).sum()).backward()
    res[f"{name}/dx"] = xg.grad.numpy()
res["pad2"] = bn.halo_pad_1d(x, 2, bn.HaloExchangerSendRecv()).numpy()

# spatial_conv3x3: forward, then the input and (summed) kernel gradients
w = conv_kernel_from_jax(arr["w"]).requires_grad_(True)
xg = x.clone().requires_grad_(True)
y = bn.spatial_conv3x3(xg, w, bn.HaloExchangerSendRecv("spatial"))
(y ** 2).sum().backward()
dw = w.grad.clone()
dist.all_reduce(dw)
res["conv/y"], res["conv/dx"], res["conv/dw"] = (y.detach().numpy(),
                                                 xg.grad.numpy(), dw.numpy())

for v, (cin, mid, cout) in spec["variants"].items():
    mod = bn.SpatialBottleneck(cin, mid, cout, axis_name="spatial",
                               device="cpu")
    mod.load_state_dict(spatial_bottleneck_state_from_jax(unflat(v)),
                        strict=False)
    xg = x.clone().requires_grad_(True)
    y = mod(xg)
    cot = torch.from_numpy(arr[f"{v}/cot"])[:, rank * hl:(rank + 1) * hl]
    (y * cot).sum().backward()
    res[f"{v}/y"] = y.detach().numpy()
    res[f"{v}/dx"] = xg.grad.numpy()
    for k, p in mod.named_parameters():
        g = p.grad.clone()
        dist.all_reduce(g)
        res[f"{v}/grad/{k}"] = g.numpy()
    for k, b in mod.named_buffers():
        res[f"{v}/buf/{k}"] = b.numpy()

dist.destroy_process_group()
np.savez(f"{out}/rank{rank}.npz", **res)
"""


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    return spawn_world(tmp_path_factory.mktemp("gloo_halo"), _WORKER, ARR,
                       {"hl": HL, "exchangers": list(EXCHANGERS),
                        "variants": VARIANTS}, world=SP)


def _mesh():
    return Mesh(np.array(jax.devices()[:SP]), ("spatial",))


def _smap(fn, in_specs, out_specs):
    return jax.jit(jax.shard_map(fn, mesh=_mesh(), in_specs=in_specs,
                                 out_specs=out_specs, check_vma=False))


_JEX = {"SendRecv": JSendRecv, "AllGather": JAllGather, "Peer": JPeer,
        "NoComm": JNoComm}
_SH = P(None, "spatial")


def _jax_exchange(name, halo):
    x = jnp.asarray(ARR["x"])

    def local(x):
        return _JEX[name]("spatial").left_right_halo_exchange(
            x[:, :halo], x[:, -halo:])

    return _smap(local, _SH, (_SH, _SH))(x)


def _slab(a, r, hl):
    return np.asarray(a)[:, r * hl:(r + 1) * hl]


@pytest.mark.parametrize("name", EXCHANGERS)
def test_exchange_matches_jax_and_neighbours(world, name):
    li, ri = _jax_exchange(name, 1)
    x = ARR["x"]
    for r in range(SP):
        got_l, got_r = world[r][f"{name}/li1"], world[r][f"{name}/ri1"]
        np.testing.assert_array_equal(got_l, _slab(li, r, 1))
        np.testing.assert_array_equal(got_r, _slab(ri, r, 1))
        if name == "NoComm":  # the local halos crossed over
            want_l, want_r = x[:, (r + 1) * HL - 1], x[:, r * HL]
        else:
            want_l = x[:, r * HL - 1] if r else np.zeros_like(x[:, 0])
            want_r = (x[:, (r + 1) * HL] if r < SP - 1
                      else np.zeros_like(x[:, 0]))
        np.testing.assert_array_equal(got_l[:, 0], want_l)
        np.testing.assert_array_equal(got_r[:, 0], want_r)


@pytest.mark.parametrize("name", EXCHANGERS)
def test_two_row_halos_and_their_gradients_match_jax(world, name):
    li, ri = _jax_exchange(name, 2)
    x = jnp.asarray(ARR["x"])
    cl = jnp.asarray(ARR["cl"]).transpose(1, 0, 2, 3, 4).reshape(
        N, SP * 2, W, C)
    cr = jnp.asarray(ARR["cr"]).transpose(1, 0, 2, 3, 4).reshape(
        N, SP * 2, W, C)

    def local(x, cl, cr):
        def loss(x):
            a, b = _JEX[name]("spatial").left_right_halo_exchange(
                x[:, :2], x[:, -2:])
            return (a * cl).sum() + (b * cr).sum()
        return jax.grad(loss)(x)

    dx = _smap(local, (_SH, _SH, _SH), _SH)(x, cl, cr)
    for r in range(SP):
        np.testing.assert_array_equal(world[r][f"{name}/li2"],
                                      _slab(li, r, 2))
        np.testing.assert_array_equal(world[r][f"{name}/ri2"],
                                      _slab(ri, r, 2))
        np.testing.assert_array_equal(world[r][f"{name}/dx"],
                                      _slab(dx, r, HL))


def test_halo_pad_shapes_and_rows(world):
    x = jnp.asarray(ARR["x"])
    out = _smap(lambda x: jhalo_pad_1d(x, 2, JSendRecv("spatial")), _SH,
                _SH)(x)
    assert out.shape == (N, SP * (HL + 4), W, C)
    for r in range(SP):
        assert world[r]["pad2"].shape == (N, HL + 4, W, C)
        np.testing.assert_array_equal(world[r]["pad2"],
                                      _slab(out, r, HL + 4))


def _dense_conv(x, w):
    return jax.lax.conv_general_dilated(
        x, w, (1, 1), "SAME", dimension_numbers=("NHWC", "HWIO", "NHWC"))


def test_spatial_conv3x3_matches_dense(world):
    x, w = jnp.asarray(ARR["x"]), jnp.asarray(ARR["w"])
    dense = _dense_conv(x, w)
    sharded = _smap(lambda x, w: jspatial_conv3x3(x, w, JSendRecv("spatial")),
                    (_SH, P()), _SH)(x, w)
    np.testing.assert_allclose(np.asarray(sharded), np.asarray(dense),
                               atol=1e-5)
    for r in range(SP):
        np.testing.assert_allclose(world[r]["conv/y"], _slab(dense, r, HL),
                                   atol=1e-5)


def test_spatial_conv3x3_grads_match_dense(world):
    x, w = jnp.asarray(ARR["x"]), jnp.asarray(ARR["w"])
    dx, dw = jax.grad(lambda x, w: (_dense_conv(x, w) ** 2).sum(),
                      argnums=(0, 1))(x, w)
    dw = np.asarray(dw).transpose(3, 2, 0, 1)  # HWIO -> [out, in, kh, kw]
    for r in range(SP):
        np.testing.assert_allclose(world[r]["conv/dx"], _slab(dx, r, HL),
                                   rtol=1e-5, atol=1e-4)
        np.testing.assert_allclose(world[r]["conv/dw"], dw, rtol=1e-5,
                                   atol=1e-4)


def _variant_params(v):
    return unflat({k[len(v) + 1:]: jnp.asarray(a) for k, a in ARR.items()
                   if k.startswith(v + "/") and not k.endswith("/cot")})


def _dense_params(sp):
    p = {k: v for k, v in sp.items() if k != "conv2_kernel"}
    p["conv2"] = {"kernel": sp["conv2_kernel"]}
    return p


def _jax_variant(v):
    cin, mid, cout = VARIANTS[v]
    sp = _variant_params(v)
    x = jnp.asarray(ARR["x"])
    bs = {b: {"mean": jnp.zeros((c,)), "var": jnp.ones((c,))}
          for b, c in (("bn1", mid), ("bn2", mid), ("bn3", cout))}
    if cin != cout:
        bs["downsample_bn"] = {"mean": jnp.zeros((cout,)),
                               "var": jnp.ones((cout,))}
    smod = JSpatialBottleneck(in_channels=cin, bottleneck_channels=mid,
                              out_channels=cout, axis_name="spatial")

    def local(p, bs, x):
        y, new = smod.apply({"params": p, "batch_stats": bs}, x,
                            mutable=["batch_stats"])
        return y, new["batch_stats"]

    y_sp, stats = _smap(local, (P(), P(), _SH), (_SH, P()))(sp, bs, x)
    dmod = JBottleneck(in_channels=cin, bottleneck_channels=mid,
                       out_channels=cout)
    cot = jnp.asarray(ARR[f"{v}/cot"])

    def dense_loss(p, x):
        y, _ = dmod.apply({"params": p, "batch_stats": bs}, x,
                          mutable=["batch_stats"])
        return (y * cot).sum(), y

    (_, y_dense), (gp, gx) = jax.value_and_grad(
        dense_loss, argnums=(0, 1), has_aux=True)(_dense_params(sp), x)
    return y_sp, y_dense, stats, gp, gx


@pytest.mark.parametrize("v", sorted(VARIANTS))
def test_spatial_bottleneck_matches_jax_and_dense(world, v):
    y_sp, y_dense, stats, gp, gx = _jax_variant(v)
    np.testing.assert_allclose(np.asarray(y_sp), np.asarray(y_dense),
                               atol=2e-5)
    for r in range(SP):
        rec = world[r]
        np.testing.assert_allclose(rec[f"{v}/y"], _slab(y_dense, r, HL),
                                   atol=2e-5)
        np.testing.assert_allclose(rec[f"{v}/dx"], _slab(gx, r, HL),
                                   atol=1e-4 * float(jnp.abs(gx).max()))
        for name, leaves in stats.items():
            for k, a in leaves.items():
                np.testing.assert_allclose(rec[f"{v}/buf/{name}.{k}"],
                                           np.asarray(a), atol=1e-6)
        sp_grads = _spatial_params(gp)
        for name, leaf in flat(sp_grads).items():
            want = np.asarray(leaf)
            if want.ndim == 4:  # HWIO -> [out, in, kh, kw]
                want = want.transpose(3, 2, 0, 1)
            key = name.replace("/", ".")
            got = rec[f"{v}/grad/{key}"]
            np.testing.assert_allclose(
                got, want, atol=1e-4 * float(np.abs(want).max()),
                err_msg=f"rank {r} {key}")
