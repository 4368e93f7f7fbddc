"""MovieLens ml-1m readers (reference python/paddle/dataset/movielens.py
— the same '::'-separated movies/users/ratings.dat files inside the
ml-1m.zip, the same MovieInfo/UserInfo value() layouts, the same
rating * 2 - 5 rescale and random train/test split)."""
import functools
import warnings
import zipfile

import numpy as np

from . import common

__all__ = ["train", "test", "get_movie_title_dict",
           "max_movie_id", "max_user_id", "max_job_id",
           "movie_categories", "user_info", "movie_info",
           "MovieInfo", "UserInfo", "age_table"]

age_table = [1, 18, 25, 35, 45, 50, 56]

URL = "http://files.grouplens.org/datasets/movielens/ml-1m.zip"


class MovieInfo:
    def __init__(self, index, categories, title):
        self.index = int(index)
        self.categories = categories
        self.title = title

    def value(self):
        return [self.index,
                [CATEGORIES_DICT[c] for c in self.categories],
                [MOVIE_TITLE_DICT[w.lower()]
                 for w in self.title.split()]]

    def __repr__(self):
        return (f"<MovieInfo id({self.index}), title({self.title}), "
                f"categories({self.categories})>")


class UserInfo:
    def __init__(self, index, gender, age, job_id):
        self.index = int(index)
        self.is_male = gender == "M"
        self.age = age_table.index(int(age))
        self.job_id = int(job_id)

    def value(self):
        return [self.index, 0 if self.is_male else 1, self.age,
                self.job_id]

    def __repr__(self):
        return (f"<UserInfo id({self.index}), "
                f"gender({'M' if self.is_male else 'F'}), "
                f"age({age_table[self.age]}), job({self.job_id})>")


MOVIE_INFO = None
MOVIE_TITLE_DICT = None
CATEGORIES_DICT = None
USER_INFO = None


def _initialize_meta_info(fn=None):
    """Parses movies.dat / users.dat exactly like the reference."""
    global MOVIE_INFO, MOVIE_TITLE_DICT, CATEGORIES_DICT, USER_INFO
    fn = fn or common.download(URL, "movielens")
    if MOVIE_INFO is None:
        categories_set = set()
        title_word_set = set()
        MOVIE_INFO = {}
        with zipfile.ZipFile(fn) as package:
            for info in package.infolist():
                assert isinstance(info, zipfile.ZipInfo)
            with package.open("ml-1m/movies.dat") as movie_file:
                for line in movie_file:
                    line = line.decode(encoding="latin")
                    movie_id, title, categories = \
                        line.strip().split("::")
                    categories = categories.split("|")
                    for c in categories:
                        categories_set.add(c)
                    title = title[:title.rfind("(")].strip()
                    for w in title.split():
                        title_word_set.add(w.lower())
                    MOVIE_INFO[int(movie_id)] = MovieInfo(
                        index=movie_id, categories=categories,
                        title=title)
            MOVIE_TITLE_DICT = {w: i for i, w in
                                enumerate(title_word_set)}
            CATEGORIES_DICT = {c: i for i, c in
                               enumerate(categories_set)}
            USER_INFO = {}
            with package.open("ml-1m/users.dat") as user_file:
                for line in user_file:
                    line = line.decode(encoding="latin")
                    uid, gender, age, job, _ = line.strip().split("::")
                    USER_INFO[int(uid)] = UserInfo(
                        index=uid, gender=gender, age=age, job_id=job)
    return fn


def _reader(rand_seed=0, test_ratio=0.1, is_test=False, fn=None):
    fn = _initialize_meta_info(fn)
    np.random.seed(rand_seed)
    with zipfile.ZipFile(fn) as package:
        with package.open("ml-1m/ratings.dat") as rating:
            for line in rating:
                line = line.decode(encoding="latin")
                if (np.random.random() < test_ratio) == is_test:
                    uid, mov_id, rating_val, _ = \
                        line.strip().split("::")
                    mov = MOVIE_INFO[int(mov_id)]
                    usr = USER_INFO[int(uid)]
                    yield usr.value() + mov.value() + [
                        [float(rating_val) * 2 - 5.0]]


def _reader_creator(**kwargs):
    try:
        _initialize_meta_info(kwargs.get("fn"))
    except common.DatasetNotDownloaded as e:
        warnings.warn(f"movielens: {e}; synthetic fallback")
        from .synthetic import movielens as syn
        return syn.train() if not kwargs.get("is_test") else syn.test()
    return lambda: _reader(**kwargs)


train = functools.partial(_reader_creator, is_test=False)
test = functools.partial(_reader_creator, is_test=True)


def get_movie_title_dict():
    _initialize_meta_info()
    return MOVIE_TITLE_DICT


def movie_categories():
    _initialize_meta_info()
    return CATEGORIES_DICT


def max_movie_id():
    _initialize_meta_info()
    return max(MOVIE_INFO.keys())


def max_user_id():
    _initialize_meta_info()
    return max(USER_INFO.keys())


def max_job_id():
    _initialize_meta_info()
    return max(u.job_id for u in USER_INFO.values())


def movie_info():
    _initialize_meta_info()
    return MOVIE_INFO


def user_info():
    _initialize_meta_info()
    return USER_INFO
