"""Real-dataset ingestion: MovieLens-100k + pairwise comparison datasets.

Counterpart of ``mfcd_tpu/data/movielens.py``, copied (numpy; pandas only
inside the loader).

Capability match for the reference's Draft layer (``Draft/helpers_1.py:14-42``
and the ``PairwiseDataset`` / self-join construction of
``Draft/Week_1.ipynb`` cell 3): load the u.user/u.item/u.data files, build
per-user pairwise comparisons from ratings, and split them by Bernoulli
mask.  Arrays come back as numpy, ready for device upload; the self-join is
vectorized per user instead of a pandas merge.
"""

from __future__ import annotations

import os
from typing import NamedTuple, Tuple

import numpy as np

USER_COLUMNS = ("user_id", "age", "gender", "occupation", "zip_code")
ITEM_COLUMNS = (
    "movie_id", "title", "release_date", "video_release_date", "IMDb_URL",
    "unknown", "Action", "Adventure", "Animation", "Children", "Comedy",
    "Crime", "Documentary", "Drama", "Fantasy", "Film-Noir", "Horror",
    "Musical", "Mystery", "Romance", "Sci-Fi", "Thriller", "War", "Western",
)
RATING_COLUMNS = ("user_id", "movie_id", "rating", "timestamp")


def load_movielens_data(folder_path: str = "Data"):
    """Load MovieLens-100k (u.user / u.item / u.data) as dataframes.

    Same contract as the reference loader (``Draft/helpers_1.py:14``):
    returns ``(users, items, ratings)``.
    """
    import pandas as pd

    users = pd.read_csv(
        os.path.join(folder_path, "u.user"), sep="|",
        names=list(USER_COLUMNS), encoding="latin-1",
    )
    items = pd.read_csv(
        os.path.join(folder_path, "u.item"), sep="|",
        names=list(ITEM_COLUMNS), encoding="latin-1",
    )
    ratings = pd.read_csv(
        os.path.join(folder_path, "u.data"), sep="\t",
        names=list(RATING_COLUMNS),
    )
    return users, items, ratings


class PairwiseDataset(NamedTuple):
    """Pairwise comparisons (Draft/Week_1.ipynb cell 3): preference is +1
    when the user rated movie_j above movie_k, else -1."""

    users: np.ndarray
    movie_j: np.ndarray
    movie_k: np.ndarray
    preferences: np.ndarray

    def __len__(self):
        return len(self.preferences)


def create_pairwise_dataset(
    user_ids: np.ndarray, movie_ids: np.ndarray, ratings: np.ndarray
) -> PairwiseDataset:
    """All ordered within-user movie pairs with distinct movies.

    Equivalent to the reference's self-join (merge on user_id, filter
    movie_j != movie_k, preference = sign(rating_j - rating_k) mapped to
    {-1, +1}) — built per user with index arithmetic instead of a pandas
    merge.
    """
    order = np.argsort(user_ids, kind="stable")
    u = np.asarray(user_ids)[order]
    mv = np.asarray(movie_ids)[order]
    rt = np.asarray(ratings)[order]

    users_out, mj, mk, pref = [], [], [], []
    boundaries = np.flatnonzero(np.diff(u)) + 1
    for chunk in np.split(np.arange(len(u)), boundaries):
        if len(chunk) < 2:
            continue
        a, b = np.meshgrid(chunk, chunk, indexing="ij")
        a, b = a.ravel(), b.ravel()
        keep = mv[a] != mv[b]
        a, b = a[keep], b[keep]
        users_out.append(u[a])
        mj.append(mv[a])
        mk.append(mv[b])
        pref.append((rt[a] > rt[b]).astype(np.int64) * 2 - 1)

    return PairwiseDataset(
        users=np.concatenate(users_out),
        movie_j=np.concatenate(mj),
        movie_k=np.concatenate(mk),
        preferences=np.concatenate(pref),
    )


class RatingsDataset(NamedTuple):
    """Sparse ratings container (Draft/Data_managing.ipynb cell 6)."""

    movies: np.ndarray
    users: np.ndarray
    ratings: np.ndarray

    def __len__(self):
        return len(self.ratings)


def split_dataset(dataset: RatingsDataset, p_test: float = 0.1, seed: int = 1):
    """Bernoulli train/test split of a ratings dataset.

    Course-scaffold utility from the Draft layer, doctested like the
    original:

    >>> import numpy as np
    >>> ds = RatingsDataset(np.array([0, 0]), np.array([1, 0]),
    ...                     np.array([2.0, 1.0]))
    >>> train, test = split_dataset(ds, p_test=0)
    >>> len(train), len(test)
    (2, 0)
    >>> train, test = split_dataset(ds, p_test=1)
    >>> len(train), len(test)
    (0, 2)
    """
    rng = np.random.default_rng(seed)
    test_mask = rng.uniform(size=len(dataset)) < p_test
    pick = lambda mask: RatingsDataset(
        dataset.movies[mask], dataset.users[mask], dataset.ratings[mask])
    return pick(~test_mask), pick(test_mask)


def to_matrix(dataset: RatingsDataset, num_movies: int, num_users: int):
    """Dense (num_movies, num_users) ratings matrix; missing entries 0.

    >>> import numpy as np
    >>> ds = RatingsDataset(np.array([0, 1]), np.array([1, 0]),
    ...                     np.array([2.0, 3.0]))
    >>> to_matrix(ds, 2, 2)
    array([[0., 2.],
           [3., 0.]])
    """
    mat = np.zeros((num_movies, num_users))
    mat[dataset.movies, dataset.users] = dataset.ratings
    return mat


def split_pairwise_dataset(
    dataset: PairwiseDataset, p_test: float = 0.1, seed: int = 1
) -> Tuple[PairwiseDataset, PairwiseDataset]:
    """Bernoulli train/test mask split (Draft/Week_1.ipynb cell 3)."""
    rng = np.random.default_rng(seed)
    test_mask = rng.uniform(size=len(dataset)) < p_test
    pick = lambda mask: PairwiseDataset(
        users=dataset.users[mask],
        movie_j=dataset.movie_j[mask],
        movie_k=dataset.movie_k[mask],
        preferences=dataset.preferences[mask],
    )
    return pick(~test_mask), pick(test_mask)
