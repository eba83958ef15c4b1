"""Skeleton graph of the ST-GCN action classifier (the port's numpy copy of
regennet_tpu/models/stgcn_graph.py, the layouts the CMDM evaluation uses).

Layouts: 'smpl' (24 joints and a root-translation node) and 'smplx' (55
and 1), from the body-model kinematic trees; the 'spatial' partition
strategy (root / closer / further), the one the classifier uses.
"""

from __future__ import annotations

import numpy as np

from regennet_torch.ops.body_model import SMPL_PARENTS, SMPLX_PARENTS


class Graph:
    def __init__(self, layout="smpl", max_hop=1, dilation=1):
        self.max_hop = max_hop
        self.dilation = dilation
        self.get_edge(layout)
        self.hop_dis = get_hop_distance(self.num_node, self.edge, max_hop=max_hop)
        self.get_adjacency()

    def get_edge(self, layout):
        if layout == "smpl":
            joints, parents = 24, SMPL_PARENTS
        elif layout == "smplx":
            joints, parents = 55, SMPLX_PARENTS
        else:
            raise NotImplementedError(f"layout {layout!r} is not ported")
        self.num_node = joints + 1
        neighbor_link = [(j, int(parents[j])) for j in range(1, joints)]
        neighbor_link.append((0, joints))  # root rotation <-> translation node
        self.center = 0
        self.edge = [(i, i) for i in range(self.num_node)] + neighbor_link

    def get_adjacency(self):
        """A [K, V, V]: for each hop, the normalised adjacency split by
        whether a neighbour is as close to the centre, closer, or further."""
        valid_hop = range(0, self.max_hop + 1, self.dilation)
        adjacency = np.zeros((self.num_node, self.num_node))
        for hop in valid_hop:
            adjacency[self.hop_dis == hop] = 1
        normalize_adjacency = normalize_digraph(adjacency)
        A = []
        for hop in valid_hop:
            a_root = np.zeros((self.num_node, self.num_node))
            a_close = np.zeros((self.num_node, self.num_node))
            a_further = np.zeros((self.num_node, self.num_node))
            for i in range(self.num_node):
                for j in range(self.num_node):
                    if self.hop_dis[j, i] == hop:
                        if self.hop_dis[j, self.center] == self.hop_dis[i, self.center]:
                            a_root[j, i] = normalize_adjacency[j, i]
                        elif self.hop_dis[j, self.center] > self.hop_dis[i, self.center]:
                            a_close[j, i] = normalize_adjacency[j, i]
                        else:
                            a_further[j, i] = normalize_adjacency[j, i]
            if hop == 0:
                A.append(a_root)
            else:
                A.append(a_root + a_close)
                A.append(a_further)
        self.A = np.stack(A)


def get_hop_distance(num_node, edge, max_hop=1):
    A = np.zeros((num_node, num_node))
    for i, j in edge:
        A[j, i] = 1
        A[i, j] = 1
    hop_dis = np.zeros((num_node, num_node)) + np.inf
    transfer_mat = [np.linalg.matrix_power(A, d) for d in range(max_hop + 1)]
    arrive_mat = np.stack(transfer_mat) > 0
    for d in range(max_hop, -1, -1):
        hop_dis[arrive_mat[d]] = d
    return hop_dis


def normalize_digraph(A):
    Dl = np.sum(A, 0)
    Dn = np.zeros_like(A)
    for i in range(A.shape[0]):
        if Dl[i] > 0:
            Dn[i, i] = Dl[i] ** (-1)
    return np.dot(A, Dn)
